"""The fused apply kernel at several CTA sizes, on the card.

    python3 scripts/apply_sweep.py [--vb 512 1024 2048] [--ept 1 2 4]

Builds the PageRank structure rmat(22, 16, seed=0) and CC's
symmetrize(rmat(21, 16, seed=1)), P=4, then runs chip_smoke's two apply
rows (the PageRank vprog, sum, over random f32 state; CC's vprog, min,
over the home ids) with the kernel built at each VB of `--vb` (home slots
a CTA, of min(VB, superstep.THREADS) threads) and each EPT of `--ept`
(route entries a thread loads in one round): the generated source's VB,
THREADS, SMEM and EPT edited, the rest as `superstep.plan` writes it.
Each variant is held bit for bit against the plain version; prints its
CTAs, its 5-call time (`cuda_ms`), the median of 5 x 20 calls and the
device time (torch.profiler) as chip_smoke times its rows, and the
kernel's own device time with a 128 MB write between calls (its inputs
out of the 50 MB L2, as a superstep leaves them).  Needs one CUDA card.
"""
import argparse
import dataclasses
import itertools
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def variant(source: str, pl, ept: int) -> str:
    """`source` with its CTA defines set from plan `pl` and EPT."""
    for name, value in (("VB", pl.vb), ("THREADS", pl.threads),
                        ("SMEM", pl.smem), ("EPT", ept)):
        source = re.sub(rf"^#define {name} \d+$", f"#define {name} {value}",
                        source, count=1, flags=re.M)
    return source


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vb", type=int, nargs="+", default=[512, 1024, 2048])
    ap.add_argument("--ept", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("apply_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import Graph
    from repro_torch.core import algorithms as alg
    from repro_torch.core import mrtriplets as mt
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import rmat, symmetrize
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import superstep as app_mod

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    gd = rmat(cs.PR_SCALE, 16, seed=0)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=cs.P, device=dev)
    g = alg.attach_out_degree(g).mapV(alg._pr_init)
    sgd = symmetrize(rmat(cs.CC_SCALE, 16, seed=1))
    sg = Graph.from_edges(sgd.src, sgd.dst, num_partitions=cs.P,
                          device=dev).mapV(alg._cc_init)
    del gd, sgd
    cases = []
    for name, gg, vprog, send, reduce, dflt in (
            ("sum (pagerank vprog)", g, alg.pagerank_vprog(0.15),
             alg.pagerank_send, "sum", torch.tensor(0.0)),
            ("min (cc vprog)", sg, alg.cc_vprog, alg.cc_send, "min",
             torch.tensor(alg.IMAX, dtype=torch.int32))):
        spec = mt._plan_apply(gg, vprog, send, reduce, None, {"m": dflt},
                              None).kernel
        s = gg.s
        send_idx = s.routes["dst"][0]
        shape = tuple(send_idx.shape)
        if reduce == "sum":
            msgs = [(torch.rand(shape, generator=gen) * 3).to(dev)]
            xs = [(torch.rand(tuple(x.shape), generator=gen) * 50 + 1).to(dev)
                  for x in tree_leaves(gg.vdata)]
        else:
            msgs = [torch.randint(0, s.max_vid + 1, shape, generator=gen,
                                  dtype=torch.int32).to(dev)]
            xs = [s.home_vid.clone()]
        flags = (send_idx >= 0) & (torch.rand(shape, generator=gen)
                                   < 0.9).to(dev)
        cases.append((name, spec, reduce, (msgs, flags, send_idx,
                                           s.apply_rng["dst"], xs, s.home_vid,
                                           gg.vmask)))
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    for name, spec, reduce, call_args in cases:
        want = ref.fused_apply(*call_args, spec, reduce=reduce)
        nl, v_blk = call_args[5].shape
        for vb, ept in itertools.product(args.vb, args.ept):
            pl = dataclasses.replace(app_mod.plan(spec.dm, spec.dv), vb=vb,
                                     threads=min(vb, app_mod.THREADS))
            pl = dataclasses.replace(pl, smem=-(-vb * (4 * pl.stride + 1)
                                                // 16) * 16)
            lib = build.load("apply", variant(app_mod.source(spec, reduce),
                                              pl, ept), app_mod._ARGTYPES)
            fn = lambda: app_mod._launch(lib, *call_args, spec)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
            if not (same and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} VB {vb}: differs from the "
                                     f"plain version")
            ms, med, dms, cold = (cs.cuda_ms(fn), cs.median_ms(fn),
                                  cs.device_ms(fn)[0],
                                  cs.cold_device_ms(fn, "apply_kernel"))
            print(f"apply[{name}] VB {vb} EPT {ept}: {pl.grid(nl, v_blk)[0]}"
                  f" x {nl} CTAs of {pl.threads} threads, smem {pl.smem} B;"
                  f" 5-call {ms:.4f} ms, median {med:.4f} ms, device "
                  f"{dms:.4f} ms, kernel with L2 cleared {cold:.4f} ms; "
                  f"bit-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
