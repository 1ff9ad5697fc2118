"""Where a PageRank superstep's time goes on the card.

    python3 scripts/profile_pagerank.py [--scale 22] [--steps 3]
        [--wires f32 int8 int8:resident fp8_e4m3:resident]

Builds rmat(scale, 16, seed=0) with P=4 on the card once; then for each
wire codec of `--wires` (a name of `core.wire.CODEC_NAMES`, ":resident"
for narrow-resident mirrors; default f32 alone) runs the fused PageRank
once to warm the kernels and traces `--steps` supersteps of a second run
with `torch.profiler` (CPU + CUDA activities).  Prints the device time by
kernel name, the wall time, and the device busy share (summed device
kernel time over wall time; concurrent kernels would count twice, the
port launches on one stream).  Needs one CUDA card.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--wires", nargs="+", default=["f32"])
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_pagerank: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import Graph, with_wire
    from repro_torch.core import algorithms as alg
    from repro_torch.data import rmat

    gd = rmat(args.scale, 16, seed=0)
    g0 = Graph.from_edges(gd.src, gd.dst, num_partitions=4)
    for spec in args.wires:
        name, _, opt = spec.partition(":")
        g = g0.replace(ex=with_wire(g0.ex, None if name == "f32" else name,
                                    resident=opt == "resident"))
        alg.pagerank(g, num_iters=2)              # build + warm the kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            alg.pagerank(g, num_iters=args.steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only: a CPU op's device time repeats its
        # kernels'
        rows = [(e.key, e.device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e6
        print(f"pagerank rmat({args.scale},16), wire {spec}, {args.steps} "
              f"supersteps + degree: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy * 1e3:.2f} ms ({busy / wall:.1%}), idle share "
              f"{1 - busy / wall:.1%}, {sum(r[2] for r in rows)} kernels")
        for kname, us, n in rows[:15]:
            print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {kname[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
