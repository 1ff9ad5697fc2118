"""The mLSTM kernels on the card: build, resources, a sweep of shapes
against the plain version, the one-TF32-term mutant, and the training
shape's times by ring depth and scan tile.

    python3 scripts/mlstm_kernel_sweep.py [--no-times]

Prints the card's name and power limit; compiles the tensor-core body
(csrc/mlstm_tc.cu) at the training shape for every (scan tile, stages)
variant timed below, at chunk 128 and at SMOKE's Dh 32, and the CUDA-core
body (csrc/mlstm.cu) at one shape, with `-Xptxas -v` into
build/repro_torch/ptxas, and prints each kernel's registers and spills.
Then, at eleven shapes [B, H, L, Dh] chunk, the body `plan` picks, the
forward's max |kernel - plain| and worst err/limit (chip_smoke's
`mlstm_bounds`), the backward's relative error per input for a random
cotangent, and whether two runs are bit-equal.  Then the one-TF32-term
mutant (scripts/mlstm_mutants.py:one_term_plan) against the same forward
limit at chip_smoke's three phase-7 shapes: the kernel must hold it at
each, the mutant break it at one at least.  Then the backward's accuracy
(`grad_readings`: kernel, plain f32, the same scan in f64, the mutant and
the split by cvt.rna, with and without the rows whose normaliser branch is
ambiguous) at the
card test's Dh-256 chunk-128 case over numpy seeds 0-4 and at the three
phase-7 shapes.  Last (unless --no-times), at
[8, 4, 1024, 256] chunk 64: forward (with states) and backward ms for scan
tiles 64x64, 128x64, 64x128 and 32x32 at 2 and 3 ring stages (`cuda_ms`,
5 calls after a warm-up; the median of 5 x 20 and the device's kernel
time beside it for the default plan); each kernel's device time by name
for the default plan and for the ABLATIONS (text edits of the source:
another operand split, one TF32 term, the scans without their state
stores or without their products); and the plain forward.  Inputs are
drawn as chip_smoke draws them (torch generator, seed 0).  Needs one
CUDA card and nvcc.
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32), (1, 4, 96, 8, 48),
          (2, 2, 32, 64, 32), (1, 1, 128, 256, 64), (2, 2, 128, 32, 64),
          (1, 2, 256, 64, 128), (1, 1, 256, 256, 128), (8, 4, 1024, 256, 64),
          (1, 2, 64, 64, 16), (1, 1, 64, 256, 16)]
# the card test's Dh-256 chunk-128 case (tests/test_torch_cuda.py) and the
# numpy seeds its inputs are read at
TEST_SHAPE, TEST_SEEDS = (1, 1, 256, 256, 128), range(5)
INPUTS = ("q", "k", "v", "logi", "logf")
VARIANTS = [(64, 64), (128, 64), (64, 128), (32, 32)]   # scan tk x tv
STAGE_SET = (2, 3)


# text edits of csrc/mlstm_tc.cu timed at the training shape to see what
# holds the kernels back (timings only: some of them compute nonsense)
ABLATIONS = [
    ("split by cvt.rna (both parts rounded to nearest TF32)",
     [("  hi = __float_as_uint(x) & 0xffffe000u;\n"
       "  lo = __float_as_uint(x - __uint_as_float(hi));",
       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
       "  const float r_ = x - __uint_as_float(hi);\n"
       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(r_));")]),
    ("one TF32 term", "one_term"),
    ("scans without their state stores",
     [("      *(float4*)(st_out + (sc + k0 + r) * D + v0 + c4) =\n"
       "          *(const float4*)(stage + r * (TV + 4) + c4);\n", "")]),
    ("scans without their products",
     [("          mma3(acc[mi][nt], a, b);\n", "")]),
]


def edited(pl, edits):
    """`pl` with its source edited (pairs of old, new text), or the
    one-TF32-term mutant's source for "one_term"."""
    import dataclasses

    import mlstm_mutants
    from repro_torch.kernels import mlstm

    class Edited(mlstm.Plan):
        def source(self) -> str:
            src = super().source()
            if edits == "one_term":
                return mlstm_mutants.one_term_source(src)
            for old, new in edits:
                if src.count(old) != 1:
                    raise AssertionError(f"edit not found once: {old!r}")
                src = src.replace(old, new)
            return src

    return Edited(**{f.name: getattr(pl, f.name)
                     for f in dataclasses.fields(pl)})


def np_inputs(b, h, l, dh, seed, dev):
    """Inputs and cotangent drawn as tests/test_torch_cuda.py draws them
    (numpy, `seed`; the cotangent from seed 1)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, l, dh)) * 0.5,
            rng.normal(size=(b, h, l, dh)) * 0.5,
            rng.normal(size=(b, h, l, dh)),
            np.clip(rng.normal(size=(b, h, l)), -8, 4),
            -np.abs(rng.normal(size=(b, h, l))) * 0.2]
    dout = np.random.default_rng(1).normal(size=(b, h, l, dh))
    return ([torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs],
            torch.from_numpy(dout.astype(np.float32)).to(dev))


def grad_readings(ins, ch, dout, variants: dict) -> dict:
    """The backward's relative error norm per input, for the cotangent as
    drawn ("all rows") and zeroed on the rows where the normaliser's branch
    is ambiguous (chip_smoke.mlstm_bounds; phase 8 zeroes them the same
    way): kernel vs plain f32 (what chip_smoke and the card test hold),
    plain f32 vs the same scan in f64, kernel vs f64, and each of
    `variants` (name: plan, e.g. the one-TF32-term mutant) vs plain f32 and
    vs f64.  Returns {reading: {input: rel}} and the number of ambiguous
    rows."""
    import torch

    import chip_smoke as cs
    import mlstm_mutants
    from repro_torch.kernels import mlstm, ref

    def autograd(fn, dout):
        a = [t.clone().requires_grad_() for t in ins]
        return torch.autograd.grad(fn(*a), a, dout)

    def direct(pl, dout):
        out, saved = mlstm._forward(pl, *ins, ch, True)
        return mlstm._backward(pl, *ins, out, dout, saved, ch)

    def rel(x, y):
        return {n: float((a.double() - b.double()).norm() / b.double().norm())
                for n, a, b in zip(INPUTS, x, y)}

    l, dh = ins[0].shape[2:]
    with torch.no_grad():
        want = ref.mlstm_chunked(*ins, chunk=ch)
        amb = cs.mlstm_bounds(*ins, ch, want)[1]
    r = {"ambiguous rows": int(amb.sum())}
    for rows, d in (("all rows", dout),
                    ("ambiguous zeroed", dout.masked_fill(amb[..., None],
                                                          0.0))):
        p = autograd(lambda *a: ref.mlstm_chunked(*a, chunk=ch), d)
        x = autograd(lambda *a: mlstm_mutants.scan(
            *a, ch, dtype=torch.float64), d)
        k = direct(mlstm.plan(min(ch, l), dh), d)
        r[f"kernel-plain, {rows}"] = rel(k, p)
        r[f"plain-f64, {rows}"] = rel(p, x)
        r[f"kernel-f64, {rows}"] = rel(k, x)
        for name, pl in variants.items():
            g = direct(pl, d)
            r[f"{name}-plain, {rows}"] = rel(g, p)
            r[f"{name}-f64, {rows}"] = rel(g, x)
    return r


def accuracy_variants(w, dh):
    """The plans grad_readings holds beside the kernel at chunk w, Dh dh:
    the one-TF32-term mutant and the split by cvt.rna (ABLATIONS[0])."""
    import mlstm_mutants
    from repro_torch.kernels import mlstm
    return {"one-term": mlstm_mutants.one_term_plan(w, dh),
            "rna-split": edited(mlstm.plan(w, dh), ABLATIONS[0][1])}


def print_readings(label, r):
    print(f"bwd accuracy {label}: ambiguous rows {r['ambiguous rows']}",
          flush=True)
    for key, per in r.items():
        if key != "ambiguous rows":
            print(f"    {key}: max {max(per.values()):.3g} ("
                  + " ".join(f"{n} {e:.3g}" for n, e in per.items()) + ")",
                  flush=True)


def kernel_ms(mlstm, pl, ins, n=5):
    """Device ms of each kernel over one forward (with states) and one
    backward at plan `pl`, the mean of n (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out, saved = mlstm._forward(pl, *ins, 64, True)
    dout = torch.ones_like(out)
    mlstm._backward(pl, *ins, out, dout, saved, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            mlstm._forward(pl, *ins, 64, True)
            mlstm._backward(pl, *ins, out, dout, saved, 64)
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / n / 1e3
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.device_time_total)
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-times", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlstm_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mlstm_mutants
    from repro_torch.kernels import build, mlstm, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    def unique(pls):
        return list({pl.source(): pl for pl in pls}.values())

    timed = unique(mlstm._tc_plan(64, 256, tk, tv, st)
                   for tk, tv in VARIANTS for st in STAGE_SET)
    plans = unique(timed + [mlstm.plan(128, 256), mlstm.plan(64, 32),
                            mlstm.plan(48, 8)])
    out_dir = ROOT / "build" / "repro_torch" / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for pl in plans:
        src = out_dir / (f"mlstm_{pl.body}_w{pl.w}_d{pl.dh}_tk{pl.tk}_tv"
                         f"{pl.tv}_s{pl.stages}.cu")
        src.write_text(pl.source())
        procs.append((pl, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{src}.so", str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    ok = True
    for pl, p in procs:
        out, _ = p.communicate()
        lines = [ln for ln in out.splitlines()
                 if "Compiling entry" in ln or "registers" in ln
                 or "spill" in ln or "error" in ln]
        print(f"{pl.body} chunk {pl.w} Dh {pl.dh} scan tile {pl.tk}x{pl.tv} "
              f"stages {pl.stages}: nvcc rc {p.returncode}; smem {pl.smem}")
        print("\n".join(lines) if p.returncode == 0 else out, flush=True)
        ok &= p.returncode == 0
    if not ok:
        return 1
    # every plan this script runs, built in parallel
    build.prebuild([("mlstm", pl.source()) for pl in plans]
                   + [("mlstm", mlstm.plan(min(c, l), dh).source())
                      for _, _, l, dh, c in SHAPES]
                   + [("mlstm", mlstm_mutants.one_term_plan(
                       min(c, l), dh).source())
                      for _, _, _, l, dh, c in cs.MLSTM_SHAPES]
                   + [("mlstm", edited(mlstm.plan(64, 256), e).source())
                      for _, e in ABLATIONS]
                   + [("mlstm", pl.source()) for c, l, dh in
                      [(TEST_SHAPE[4], TEST_SHAPE[2], TEST_SHAPE[3])]
                      + [(c, l, dh) for *_, l, dh, c in cs.MLSTM_SHAPES]
                      for pl in accuracy_variants(min(c, l), dh).values()])

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def kernel(q, k, v, logi, logf, chunk):
        return mlstm.mlstm_chunked(q, k, v, logi, logf, chunk=chunk)

    for b, h, l, dh, ch in SHAPES:
        ins = cs.mlstm_inputs(b, h, l, dh, gen, dev)
        dout = torch.randn((b, h, l, dh), generator=gen).to(dev)
        pl = mlstm.plan(min(ch, l), dh)
        try:
            r = cs.mlstm_check(kernel, *ins, ch, dout)
            msg = (f"fwd max|err| {r['max_abs_err']:.3g} worst err/limit "
                   f"{r['worst_err_over_limit']:.3g}; bwd relnorm "
                   + " ".join(f"{n} {e:.3g}"
                              for n, e in r["grad_rel_err"].items()))
        except AssertionError as e:
            ok, msg = False, f"FAILS: {e}"
        a = [t.clone().requires_grad_() for t in ins]
        o1 = mlstm.mlstm_chunked(*a, chunk=ch)
        g1 = torch.autograd.grad(o1, a, dout)
        o2 = mlstm.mlstm_chunked(*a, chunk=ch)
        g2 = torch.autograd.grad(o2, a, dout)
        det = torch.equal(o1, o2) and all(map(torch.equal, g1, g2))
        ok &= det
        print((b, h, l, dh, ch), pl.body, msg, "; deterministic", det,
              flush=True)

    # the one-TF32-term mutant against the forward limit: the kernel must
    # hold it at every shape, the mutant break it at one at least
    caught = False
    for name, b, h, l, dh, ch in cs.MLSTM_SHAPES:
        ins = cs.mlstm_inputs(b, h, l, dh, gen, dev)
        with torch.no_grad():
            want = ref.mlstm_chunked(*ins, chunk=ch)
            limit = cs.mlstm_bounds(*ins, ch, want)[0]
            ratios = {}
            for kind, pl in (("three-term", mlstm.plan(min(ch, l), dh)),
                             ("one-term", mlstm_mutants.one_term_plan(
                                 min(ch, l), dh))):
                out = mlstm._forward(pl, *ins, ch, False)[0]
                diff = (out.double() - want.double()).abs()
                ratios[kind] = (float((diff / limit).max()),
                                int((diff > limit).sum()))
        ok &= ratios["three-term"][0] <= 1
        caught |= ratios["one-term"][0] > 1
        print(f"mutant [{name}] [{b}, {h}, {l}, {dh}] chunk {ch}: "
              + "; ".join(f"{k} worst err/limit {r:.3g} ({n} outputs over)"
                          for k, (r, n) in ratios.items()), flush=True)
        del ins, want, limit
    print(f"one-term mutant {'fails' if caught else 'PASSES'} the forward "
          "limit at some shape")
    ok &= caught

    # the backward's accuracy (grad_readings): the card test's Dh-256
    # chunk-128 case over its seeds, then chip_smoke's phase-7 shapes with
    # the one-TF32-term mutant beside the kernel
    worst = {}
    for seed in TEST_SEEDS:
        b, h, l, dh, ch = TEST_SHAPE
        ins, dout = np_inputs(b, h, l, dh, seed, dev)
        r = grad_readings(ins, ch, dout, accuracy_variants(min(ch, l), dh))
        print_readings(f"[card test {TEST_SHAPE}, numpy seed {seed}]", r)
        for key, per in r.items():
            if key != "ambiguous rows":
                worst[key] = max(worst.get(key, 0.0), *per.values())
    for name, b, h, l, dh, ch in cs.MLSTM_SHAPES:
        ins = cs.mlstm_inputs(b, h, l, dh, gen, dev)
        dout = torch.randn((b, h, l, dh), generator=gen).to(dev)
        r = grad_readings(ins, ch, dout, accuracy_variants(min(ch, l), dh))
        print_readings(f"[{name}] [{b}, {h}, {l}, {dh}] chunk {ch}", r)
        for key, per in r.items():
            if key != "ambiguous rows":
                worst[key] = max(worst.get(key, 0.0), *per.values())
        del ins, dout, r
    print("bwd accuracy, largest over these cases: "
          + "; ".join(f"{k} {e:.3g}" for k, e in worst.items()), flush=True)
    if args.no_times:
        print("OK" if ok else "SWEEP FOUND A FAULT")
        return 0 if ok else 1

    ins = cs.mlstm_inputs(8, 4, 1024, 256, gen, dev)
    for pl in timed:
        kept = {}

        def fwd():
            kept["r"] = mlstm._forward(pl, *ins, 64, True)

        f_ms = cs.cuda_ms(fwd)
        out, saved = kept["r"]
        dout = torch.randn_like(out)
        def bwd():
            mlstm._backward(pl, *ins, out, dout, saved, 64)

        b_ms = cs.cuda_ms(bwd)
        extra = ""
        if pl == mlstm.plan(64, 256):
            nograd = cs.cuda_ms(lambda: mlstm.forward(*ins, chunk=64,
                                                      states=False))
            extra = (f"; default plan: fwd median {cs.median_ms(fwd):.4f} "
                     f"device {cs.device_ms(fwd)[0]:.4f}, bwd median "
                     f"{cs.median_ms(bwd):.4f} device {cs.device_ms(bwd)[0]:.4f}"
                     f"; no-grad fwd {nograd:.4f}")
        print(f"[8, 4, 1024, 256] chunk 64, scan tile {pl.tk}x{pl.tv}, "
              f"stages {pl.stages}: fwd {f_ms:.4f} ms, bwd {b_ms:.4f} ms"
              + extra, flush=True)
        del kept, out, saved, dout

    for name, pl in [("default plan", mlstm.plan(64, 256))] + [
            (n, edited(mlstm.plan(64, 256), e)) for n, e in ABLATIONS]:
        times = kernel_ms(mlstm, pl, ins)
        print(f"  {name}: fwd + bwd device ms by kernel: "
              + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
              + f"; sum {sum(times.values()):.4f}", flush=True)
    print("plain fwd ms", cs.cuda_ms(lambda: ref.mlstm_chunked(
        *ins, chunk=64), 2))
    print("OK" if ok else "SWEEP FOUND A FAULT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
