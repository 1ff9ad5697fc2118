"""How far xlstm-350m's step-1 loss and gradients move between evaluations
that differ only by rounding, on the card.

    python3 scripts/train_grad_spread.py

Draws xlstm-350m in full (`train_loop.init_params`, seed 0) and takes
`SyntheticLM` seed 0's first batch (batch 8, seq 1024).  Computes the loss
and the gradient of every leaf four times: through the mLSTM kernels, the
same again, through the plain versions, and through the plain versions
with every weight multiplied by (1 + 1e-6 N(0, 1)) (generator seed 5).
Prints the four losses and, per leaf, the plain gradient's norm and the
relative norm of (kernels - plain), (kernels - kernels again) and
(perturbed plain - plain).  Then, for the first super-layer's three mLSTM
blocks, the range of logi and its clipped share, the mean logf, the range
of the stabiliser m and the share of rows whose normaliser is clamped
(|den| < exp(-m)).  These readings set chip_smoke.py's phase-8 loss limit
and show why it compares no whole-model gradients.
Needs one CUDA card.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_grad_spread: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs as C
    from repro_torch.core.tree import (tree_flatten_with_path, tree_leaves,
                                       tree_map)
    from repro_torch.data.tokens import SyntheticLM
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.train import train_loop as tl

    dev = torch.device("cuda")
    cfg = C.get("xlstm-350m")
    params = tl.init_params(cfg, 0, dev)
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in tree_flatten_with_path(params)[0]]
    batch = {k: torch.from_numpy(a).to(dev) for k, a in SyntheticLM(
        cfg.vocab, 1024, 8, seed=0).batch(0).items()}

    def loss_grads(mode, ps):
        t = time.perf_counter()
        loss = T.loss_fn(ps, batch, cfg, mode=mode)
        g = torch.autograd.grad(loss, tree_leaves(ps))
        torch.cuda.synchronize()
        return float(loss.detach()), g, time.perf_counter() - t

    lk, gk, tk = loss_grads("auto", params)
    lk2, gk2, _ = loss_grads("auto", params)
    lr, gr, tr = loss_grads("ref", params)
    gen = torch.Generator(device=dev).manual_seed(5)
    pert = tree_map(lambda t: (t.detach() * (1 + 1e-6 * torch.randn(
        t.shape, generator=gen, device=dev))).requires_grad_(True), params)
    lp, gp, _ = loss_grads("ref", pert)
    print(f"loss kernel {lk:.7f} again {lk2:.7f} plain {lr:.7f} "
          f"plain(perturbed 1e-6) {lp:.7f}; seconds kernel {tk:.2f} "
          f"plain {tr:.2f}")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    print("leaf | norm(plain grad) | rel(kernel, plain) | "
          "rel(kernel, kernel again) | rel(plain perturbed, plain)")
    for i, n in enumerate(names):
        print(f"{i:2d} {n:28s} {float(gr[i].norm()):.3e} "
              f"{rel(gk[i], gr[i]):.3e} {rel(gk2[i], gk[i]):.3e} "
              f"{rel(gp[i], gr[i]):.3e}")
    with torch.no_grad():
        x = L.embed(params["embed"], batch["tokens"])
        for j in range(3):
            slot = params["blocks"][f"slot{j}"]
            p = {k: v[0] for k, v in slot["mix"].items()}
            h = L.rms_norm(x, slot["ln1"][0], cfg.norm_eps)
            li, lf = R._mlstm_gates(p, h)
            q, k, v = R._qkv(p, h)
            _, den, m = ref.mlstm_parts(q, k, v, li, lf, chunk=64)
            clamped = float((den.abs() < torch.exp(-m)).float().mean())
            clipped = float(((li <= -12) | (li >= 8)).float().mean())
            print(f"slot{j}: logi range [{float(li.min()):.2f}, "
                  f"{float(li.max()):.2f}] clipped frac {clipped:.4f}; "
                  f"logf mean {float(lf.mean()):.3f}; m range "
                  f"[{float(m.min()):.2f}, {float(m.max()):.2f}]; clamp "
                  f"active frac {clamped:.3f}")
            x = x + R.mlstm_block(p, h, chunk=64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
