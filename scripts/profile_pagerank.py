"""Where a PageRank superstep's time goes on the card, and the apply half's
share of it.

    python3 scripts/profile_pagerank.py [--scale 22] [--steps 3]
        [--wires f32 int8 int8:resident fp8_e4m3:resident] [--cc]

Builds rmat(scale, 16, seed=0) with P=4 on the card once; then for each
wire codec of `--wires` (a name of `core.wire.CODEC_NAMES`, ":resident"
for narrow-resident mirrors; default f32 alone) runs the fused PageRank
once to warm the kernels, times `--steps` supersteps untraced
(synchronised), and traces `--steps` supersteps of a third run with
`torch.profiler` (CPU + CUDA activities).  Prints the untraced ms per
superstep, the device time by kernel name, the traced wall time, the
device busy share (summed device kernel time over wall time; concurrent
kernels would count twice, the port launches on one stream), and the home
half of each superstep: the device launches under the Pregel loop's
`record_function("apply_home")` span around `fused_apply_home` in the
eager superstep 1, and the same kernels, by name, in the replays of the
captured superstep (`repro_torch.profiling.span_stats`), and their device
time.  With
`--cc`, connected components on symmetrize(rmat(scale - 1, 16, seed=1))
the same way: the untraced seconds to convergence, then a traced run's
home half.  Needs one CUDA card.
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
    ap.add_argument("--cc", action="store_true")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        print("profile_pagerank: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import Graph, with_wire
    from repro_torch.core import algorithms as alg
    from repro_torch.data import rmat, symmetrize
    from repro_torch.profiling import busy, home_line, span_stats, traced

    gd = rmat(args.scale, 16, seed=0)
    g0 = Graph.from_edges(gd.src, gd.dst, num_partitions=4)
    for spec in args.wires:
        name, _, opt = spec.partition(":")
        g = g0.replace(ex=with_wire(g0.ex, None if name == "f32" else name,
                                    resident=opt == "resident"))
        alg.pagerank(g, num_iters=2)              # build + warm the kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alg.pagerank(g, num_iters=args.steps)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) / args.steps
        _, wall, prof = traced(lambda: alg.pagerank(g, num_iters=args.steps))
        # device-side events only: a CPU op's device time repeats its
        # kernels'
        rows = [(e.key, e.device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0 and e.key != "apply_home"]
        rows.sort(key=lambda r: -r[1])
        busy_ms, n_events = busy(prof)
        print(f"pagerank rmat({args.scale},16), wire {spec}, {args.steps} "
              f"supersteps + degree: untraced {untraced * 1e3:.3f} ms per "
              f"superstep (incl. the degree pass); traced wall "
              f"{wall * 1e3:.2f} ms, device busy {busy_ms:.2f} ms "
              f"({busy_ms / 1e3 / wall:.1%}), idle share "
              f"{1 - busy_ms / 1e3 / wall:.1%}, {n_events} kernels")
        print(f"  {home_line(span_stats(prof), args.steps)}")
        for kname, us, n in rows[:15]:
            print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {kname[:90]}")
    if args.cc:
        del g0, g
        sgd = symmetrize(rmat(args.scale - 1, 16, seed=1))
        sg = Graph.from_edges(sgd.src, sgd.dst, num_partitions=4)
        alg.connected_components(sg, max_supersteps=2)        # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = alg.connected_components(sg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        r2, wall, prof = traced(lambda: alg.connected_components(sg))
        print(f"cc symmetrize(rmat({args.scale - 1},16)): {r.supersteps} "
              f"supersteps, untraced {secs:.4f} s to convergence; traced "
              f"wall {wall:.4f} s")
        print(f"  {home_line(span_stats(prof), r2.supersteps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
