"""The mLSTM kernels' first check on the card: build, resources, a sweep of
shapes against the plain version, and the training shape's times.

    python3 scripts/mlstm_kernel_sweep.py

Prints the card's name and power limit; compiles csrc/mlstm.cu for five
(chunk, value tile) pairs with `-Xptxas -v` into build/repro_torch/ptxas
and prints each kernel's registers and spills; then, at nine shapes
[B, H, L, Dh] chunk, the forward's max |kernel - plain| and max relative
error (1e-3 floor), the backward's relative error per input for a random
cotangent, and whether two runs are bit-equal; last, at [8, 4, 1024, 256]
chunk 64, the forward (with and without the chunk-entry states), the
backward and the plain forward in ms (CUDA events, mean of five after a
warm-up).  Inputs are drawn as tests/test_kernels.py draws them (torch
generator, seed 0).  Needs one CUDA card and nvcc.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32), (1, 4, 96, 8, 48),
          (2, 2, 32, 64, 32), (1, 1, 128, 256, 64), (2, 2, 128, 32, 64),
          (1, 2, 256, 64, 128), (1, 1, 256, 256, 128), (8, 4, 1024, 256, 64)]
BUILDS = [(64, 64), (128, 16), (32, 32), (48, 16), (128, 32)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mlstm_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, mlstm, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "repro_torch" / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    for w, tv in BUILDS:
        src = out_dir / f"mlstm_w{w}_tv{tv}.cu"
        src.write_text(mlstm.source(w, tv))
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-o", f"{src}.so", str(src)],
                           capture_output=True, text=True)
        lines = [l for l in (r.stdout + r.stderr).splitlines()
                 if "entry function" in l or "registers" in l
                 or "spill" in l or "error" in l]
        print(f"chunk {w}, tile {tv}: nvcc rc {r.returncode}")
        print("\n".join(lines))

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def inputs(b, h, l, dh):
        q = torch.randn(b, h, l, dh, generator=g) * 0.5
        k = torch.randn(b, h, l, dh, generator=g) * 0.5
        v = torch.randn(b, h, l, dh, generator=g)
        li = torch.randn(b, h, l, generator=g).clamp(-8, 4)
        lf = -torch.randn(b, h, l, generator=g).abs() * 0.2
        return [t.to(dev) for t in (q, k, v, li, lf)]

    for b, h, l, dh, ch in SHAPES:
        ins = inputs(b, h, l, dh)
        a = [t.clone().requires_grad_() for t in ins]
        p = [t.clone().requires_grad_() for t in ins]
        out = mlstm.mlstm_chunked(*a, chunk=ch)
        want = ref.mlstm_chunked(*p, chunk=ch)
        dout = torch.randn(out.shape, generator=g).to(dev)
        ga = torch.autograd.grad(out, a, dout)
        gp = torch.autograd.grad(want, p, dout)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        rel = ((out - want).abs() / (want.abs() + 1e-3)).max().item()
        rels = [((x - y).norm() / y.norm()).item() for x, y in zip(ga, gp)]
        out2 = mlstm.mlstm_chunked(*a, chunk=ch)
        ga2 = torch.autograd.grad(out2, a, dout)
        det = torch.equal(out, out2) and all(
            torch.equal(x, y) for x, y in zip(ga, ga2))
        print((b, h, l, dh, ch), f"fwd max|err| {err:.3g} maxrel {rel:.3g};"
              f" bwd relnorm", ["%.3g" % r for r in rels],
              "deterministic", det, flush=True)

    ins = inputs(8, 4, 1024, 256)

    def ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    kept = {}

    def fwd_states():
        kept["r"] = mlstm.forward(*ins, chunk=64, states=True)

    print("fwd(states) ms", ms(fwd_states))
    print("fwd(no states) ms", ms(lambda: mlstm.forward(*ins, chunk=64,
                                                         states=False)))
    out, c, n = kept["r"]
    dout = torch.randn_like(out)
    print("bwd ms", ms(lambda: mlstm.backward(*ins, out, dout, c, n,
                                              chunk=64)))
    print("plain fwd ms", ms(lambda: ref.mlstm_chunked(*ins, chunk=64), 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
