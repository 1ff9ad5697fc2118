"""Dry run of chip_smoke.py's phase-7 mLSTM checks on the CPU, with mutant
"kernels" that must fail them.

    PYTHONPATH=src python scripts/mlstm_mutants.py

Each "kernel" is a copy of the plain chunk scan with one fault switched on:
  * sound       — the scan in float64, rounded to f32 (another evaluation,
                  no fault): must pass every check;
  * drop_inter  — chunk j leaves out its inter-chunk term q C (forward);
  * cut_carry   — the carried C and n pass no gradient back across the
                  boundary into chunk j (forward unchanged; the backward
                  kernel's dC/dn carry cut at one chunk boundary).
It prints each check's reading and exits non-zero if a mutant passes or the
sound kernel fails.

`one_term_plan` is the card's mutant: the tensor-core body built from its
own source with the two lo terms of every three-term TF32 product cut out
by a text edit (one TF32 term, 2^-11 per operand), which must fail the
forward's limit where the three-term kernel holds it.  It runs on the card
from scripts/mlstm_kernel_sweep.py; here the dry run only checks that the
edit finds its two lines.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import mlstm  # noqa: E402

LO_TERM = "// lo term"


def one_term_source(src: str) -> str:
    """csrc/mlstm_tc.cu's text with the lines of `mma3` marked as lo terms
    removed: each product is then hi*hi alone."""
    lines = src.splitlines(keepends=True)
    cut = [ln for ln in lines if LO_TERM in ln]
    if len(cut) != 2:
        raise AssertionError(f"one-term mutant: {len(cut)} lo-term lines")
    return "".join(ln for ln in lines if LO_TERM not in ln)


class OneTermPlan(mlstm.Plan):
    """A tensor-core plan whose source is `one_term_source` of its own."""

    def source(self) -> str:
        return one_term_source(super().source())


def one_term_plan(w: int, dh: int) -> OneTermPlan:
    pl = mlstm.plan(w, dh)
    if pl.body != "tensor_core":
        raise ValueError(f"one-term mutant: chunk {w}, Dh {dh} runs "
                         f"{pl.body}")
    return OneTermPlan(**{f.name: getattr(pl, f.name)
                          for f in dataclasses.fields(pl)})


def scan(q, k, v, logi, logf, chunk, *, dtype=torch.float32,
         drop_inter=None, cut_carry=None):
    """The plain chunk scan (kernels/ref.py:mlstm_parts, then the division)
    with a fault at chunk `drop_inter` or `cut_carry`."""
    b, h, l, dh = q.shape
    w = min(chunk, l)
    nc = l // w

    def chunks(x):
        return x.to(dtype).reshape(b, h, nc, w, *x.shape[3:]).movedim(2, 0)

    tri = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    C = torch.zeros((b, h, dh, dh), dtype=dtype, device=q.device)
    n = torch.zeros((b, h, dh), dtype=dtype, device=q.device)
    outs = []
    for c, (qc, kc, vc, lic, lfc) in enumerate(zip(*map(chunks, (
            q, k, v, logi, logf)))):
        if c == cut_carry:
            C, n = C.detach(), n.detach()
        cum = torch.cumsum(lfc, -1)
        total = cum[..., -1:]
        dmat = cum[..., :, None] - cum[..., None, :] + lic[..., None, :]
        dmat = torch.where(tri, dmat, float("-inf"))
        m_row = torch.maximum(dmat.amax(-1), cum)
        att = torch.einsum("bhtk,bhsk->bhts", qc, kc) * torch.exp(
            dmat - m_row[..., None])
        dec = torch.exp(cum - m_row)
        num = torch.einsum("bhts,bhsk->bhtk", att, vc)
        if c != drop_inter:
            num = num + torch.einsum("bhtk,bhkv->bhtv", qc * dec[..., None], C)
        den = att.sum(-1) + torch.einsum("bhtk,bhk->bht", qc * dec[..., None],
                                         n)
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_row))[..., None])
        wgt = torch.exp(total - cum + lic)
        C = torch.exp(total)[..., None] * C + torch.einsum(
            "bhsk,bhsv->bhkv", kc * wgt[..., None], vc)
        n = torch.exp(total) * n + torch.einsum("bhsk,bhs->bhk", kc, wgt)
    return torch.cat(outs, 2).float()


def main() -> int:
    gen = torch.Generator().manual_seed(0)
    ok = True
    for b, h, l, dh, chunk in ((2, 2, 256, 32, 64), (1, 2, 512, 64, 64)):
        q, k, v, logi, logf = chip_smoke.mlstm_inputs(b, h, l, dh, gen, "cpu")
        dout = torch.randn((b, h, l, dh), generator=gen)
        j = l // chunk // 2
        kernels = {
            "sound": lambda *a: scan(*a, dtype=torch.float64),
            f"drop_inter(chunk {j})": lambda *a: scan(*a, drop_inter=j),
            f"cut_carry(chunk {j})": lambda *a: scan(*a, cut_carry=j),
        }
        for name, kern in kernels.items():
            want_pass = name == "sound"
            try:
                r = chip_smoke.mlstm_check(kern, q, k, v, logi, logf, chunk,
                                           dout)
                msg = (f"passes: worst err/limit "
                       f"{r['worst_err_over_limit']:.3g}, grad rel "
                       f"{max(r['grad_rel_err'].values()):.3g}")
                if l == 256:
                    with torch.no_grad():
                        out = kern(q, k, v, logi, logf, chunk)
                    rr = chip_smoke.mlstm_recurrence_check(
                        out, q, k, v, logi, logf, chunk)
                    msg += (f"; vs recurrence err/limit "
                            f"{rr['worst_err_over_limit']:.3g}")
                passed = True
            except AssertionError as e:
                msg, passed = f"fails: {e}", False
            ok &= passed == want_pass
            print(f"[{b},{h},{l},{dh}] chunk {chunk} {name}: {msg}")
    cut = (len(mlstm.plan(64, 256).source().splitlines())
           - len(one_term_plan(64, 256).source().splitlines()))
    print(f"one-term mutant: {cut} lo-term lines cut (runs on the card)")
    print("OK" if ok else "MUTATION CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
