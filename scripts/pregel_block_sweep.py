"""The Pregel drivers on the card, and the block size of `pregel_fused`.

    python3 scripts/pregel_block_sweep.py [--scale 22] [--blocks 1 2 3 4 8]

Builds rmat(scale, 16, seed=0) with P=4 on the card, attaches out-degrees
and runs PageRank as static (tol 0, 10 and 20 supersteps) and delta (tol
1e-3, which halts on its own) through three drivers: the eager loop (a
loop over `core.pregel._superstep`, here), `pregel` (superstep 1 eager,
the rest replaying one captured superstep) and `pregel_fused` at each
block size K of `--blocks` (the module constant `FUSED_BLOCK`, set here
for the sweep).  Every run is held bit-equal to the eager loop, with its
superstep count.  Prints, for each driver and run, the milliseconds of the
whole run (host clock, synchronised), the
supersteps, the capture seconds, the launches of the apply kernel (masked
supersteps launch too) and the peak device memory, for the run whose time
less its own capture is the median of 5 after a warm-up, and that time
over the supersteps.  Needs one CUDA card.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


REPS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 2, 3, 4, 8])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pregel_block_sweep: no CUDA device", file=sys.stderr)
        return 2
    import importlib
    from repro_torch.core import Graph, capture, pregel, pregel_fused
    from repro_torch.core import algorithms as alg
    from repro_torch.core import mrtriplets as mt
    from repro_torch.core.tree import tree_map
    from repro_torch.data import rmat
    from repro_torch.kernels import ops
    pm = importlib.import_module("repro_torch.core.pregel")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    t0 = time.perf_counter()
    gd = rmat(args.scale, 16, seed=0)
    g = alg.attach_out_degree(Graph.from_edges(gd.src, gd.dst,
                                               num_partitions=4))
    torch.cuda.synchronize()
    print(f"rmat({args.scale},16): {g.s.num_vertices} vertices, "
          f"{g.s.num_edges} edges, built in {time.perf_counter() - t0:.1f} s")
    zero = {"m": torch.tensor(0.0)}
    dvp, dch = alg.delta_pagerank_fns(0.15, 1e-3)
    runs = {
        "static 10": (g.mapV(alg._pr_init), alg.pagerank_vprog(0.15),
                      alg.pagerank_send, dict(max_supersteps=10,
                                              skip_stale=None)),
        "static 20": (g.mapV(alg._pr_init), alg.pagerank_vprog(0.15),
                      alg.pagerank_send, dict(max_supersteps=20,
                                              skip_stale=None)),
        "delta 1e-3": (g.mapV(lambda vid, v: {
            **v, "pr": torch.tensor(0.15), "delta": torch.tensor(0.15)}),
            dvp, alg.delta_pagerank_send,
            dict(max_supersteps=100, skip_stale="out", changed_fn=dch))}

    def eager(gi, vprog, send, kw):
        aplan = mt._plan_apply(gi, vprog, send, "sum", kw.get("changed_fn"),
                               zero, None)
        dmsg = tree_map(lambda d: torch.as_tensor(d).to(gi.device), zero)
        steps = 0
        for _ in range(kw["max_supersteps"]):
            gi, live, _ = pm._superstep(
                gi, vprog=vprog, send_msg=send, gather="sum",
                default_msg=dmsg, skip_stale=kw["skip_stale"],
                changed_fn=kw.get("changed_fn"), kernel_mode="auto",
                use_cache=True, payload_bound=None, aplan=aplan)
            steps += 1
            if int(live) == 0:
                break
        return gi, steps

    def timed(fn):
        """(result, ms, apply launches, capture s, peak GiB) of the run
        whose ms less its own capture is the median of REPS."""
        fn()                                    # warm: builds, lazy handles
        runs = []
        for _ in range(REPS):
            ops.reset_launch_counts()
            capture.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            runs.append((ms - capture.stats["capture_s"] * 1e3, ms, out,
                         ops.launch_counts()["apply"],
                         capture.stats["capture_s"],
                         torch.cuda.max_memory_allocated() / 2**30,
                         capture.stats["instantiate_s"]))
        runs.sort(key=lambda r: r[0])
        _, ms, out, apply_n, cap, peak, inst = runs[len(runs) // 2]
        caps.append((cap, inst))
        return out, ms, apply_n, cap, peak

    caps = []

    def same(a, b):
        ta, sa = capture.flatten(pm._carry(a))
        tb, sb = capture.flatten(pm._carry(b))
        return sa == sb and all(torch.equal(x, y) for x, y in zip(ta, tb))

    for label, (gi, vprog, send, kw) in runs.items():
        (want, n), ms, apply_n, _, peak = timed(
            lambda: eager(gi, vprog, send, kw))
        print(f"{label}: eager loop {ms:.2f} ms, {n} supersteps "
              f"({ms / n:.3f} ms each), apply launches {apply_n}, peak "
              f"{peak:.2f} GiB")
        r, ms, apply_n, cap, peak = timed(lambda: pregel(
            gi, vprog, send, "sum", default_msg=zero, **kw))
        ok = same(r.graph, want) and r.supersteps == n
        print(f"  pregel (captured): {ms:.2f} ms ({ms / n:.3f} ms a "
              f"superstep, {(ms - cap * 1e3) / n:.3f} without the capture), "
              f"capture {cap * 1e3:.1f} ms, apply launches "
              f"{apply_n}, peak {peak:.2f} GiB, == eager: {ok}")
        if not ok:
            return 1
        for k in args.blocks:
            pm.FUSED_BLOCK = k
            (gf, steps), ms, apply_n, cap, peak = timed(lambda: pregel_fused(
                gi, vprog, send, "sum", default_msg=zero, **kw))
            ok = same(gf, want) and int(steps) == n
            print(f"  pregel_fused K={k}: {ms:.2f} ms ({ms / n:.3f} ms a "
                  f"superstep, {(ms - cap * 1e3) / n:.3f} without the "
                  f"capture), capture {cap * 1e3:.1f} ms, apply launches "
                  f"{apply_n} ({apply_n - n} masked), peak {peak:.2f} GiB, "
                  f"== eager: {ok}")
            if not ok:
                return 1
    print("captures (ms, of which capture_end): " + ", ".join(
        f"{c * 1e3:.1f} ({i * 1e3:.1f})" for c, i in caps if c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
