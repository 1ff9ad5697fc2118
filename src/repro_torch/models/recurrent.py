"""Recurrent sequence mixing of xLSTM: mLSTM (matrix memory) and sLSTM.

The port of the mLSTM and sLSTM halves of `repro/models/recurrent.py`
(RG-LRU waits: ROADMAP Queue 1 slice 10), with the reference's casts: bf16
projections, f32 gates, state and output gate.

* mLSTM, full sequence: the chunkwise scan goes through
  `kernels.ops.mlstm_chunked` (the CUDA kernels on the card, forward and
  backward; the plain scan on the CPU), whose math is the reference's
  `chunk_step` op for op.
* mLSTM, one token: the plain recurrence of `mlstm_step` (`mlstm_cell`).
* sLSTM: a plain time loop, as the reference's `lax.scan`; it has no
  kernel.  The gate transforms that do not depend on the carried state
  (clip, softplus, sigmoid) run once over the whole sequence before the
  loop, elementwise as in the reference's step, so the loop keeps only the
  recurrent ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from . import layers as L

_LOG_EPS = -12.0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(cfg, *, generator: torch.Generator, device,
               lead: tuple = ()) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    return {"wq": L.normal(lead + (d, h, dh), d ** -0.5, **kw),
            "wk": L.normal(lead + (d, h, dh), d ** -0.5, **kw),
            "wv": L.normal(lead + (d, h, dh), d ** -0.5, **kw),
            "wi": L.normal(lead + (d, h), d ** -0.5, **kw),
            "wf": L.normal(lead + (d, h), d ** -0.5, **kw),
            "wo": L.normal(lead + (h, dh, d), (h * dh) ** -0.5, **kw),
            "wog": L.normal(lead + (d, h, dh), d ** -0.5, **kw)}


def _mlstm_gates(p: dict, x: torch.Tensor):
    """log input / forget gates [B, H, L] f32: logi clamped, logf <= 0."""
    xf = x.float()
    logi = torch.einsum("bld,dh->bhl", xf, p["wi"].float()).clamp(
        _LOG_EPS, 8.0)
    logf = -F.softplus(-torch.einsum("bld,dh->bhl", xf, p["wf"].float())
                       - 1.0)
    return logi, logf


def _qkv(p: dict, x: torch.Tensor):
    """f32 q (scaled by Dh^-0.5), k, v [B, H, L, Dh] from bf16 projections."""
    dh = p["wq"].shape[2]
    q = L.project_heads(x, p["wq"]).float() * dh ** -0.5
    return q, L.project_heads(x, p["wk"]).float(), \
        L.project_heads(x, p["wv"]).float()


def _output(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The f32 output gate on y [B, H, L, Dh], then the bf16 projection."""
    og = torch.sigmoid(torch.einsum("bld,dhk->bhlk", x.float(),
                                    p["wog"].float()))
    return L.merge_heads(y * og, p["wo"], x.dtype)


def mlstm_block(p: dict, x: torch.Tensor, *, chunk: int = 64,
                mode: str = "auto") -> torch.Tensor:
    """x [B, L, D] -> [B, L, D]; chunkwise-parallel matrix-memory mixing."""
    q, k, v = _qkv(p, x)
    logi, logf = _mlstm_gates(p, x)
    y = kops.mlstm_chunked(q, k, v, logi, logf, chunk=chunk, mode=mode)
    return _output(p, x, y)


def mlstm_init_state(b: int, h: int, dh: int, *, lead: tuple = (),
                     device=None) -> dict:
    z = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (b, h, dh, dh), **z),
            "n": torch.zeros(lead + (b, h, dh), **z),
            "m": torch.zeros(lead + (b, h), **z)}


def mlstm_cell(q, k, v, logi, logf, state: dict):
    """One token of the mLSTM recurrence (`mlstm_step`'s math): q/k/v
    [B, H, Dh] f32 (q scaled), logi/logf [B, H] -> (h [B, H, Dh], state')."""
    m2 = torch.maximum(state["m"] + logf, logi)
    fi = torch.exp(state["m"] + logf - m2)[..., None]
    ii = torch.exp(logi - m2)[..., None]
    C = fi[..., None] * state["C"] + ii[..., None] * k[..., :, None] \
        * v[..., None, :]
    n = fi * state["n"] + ii * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.einsum("bhk,bhk->bh", q, n)
    y = num / torch.maximum(den.abs(), torch.exp(-m2))[..., None]
    return y, {"C": C, "n": n, "m": m2}


def mlstm_step(p: dict, x: torch.Tensor, state: dict):
    """Single-token decode.  x [B, 1, D] -> ([B, 1, D], state')."""
    q, k, v = (t[:, :, 0] for t in _qkv(p, x))
    logi, logf = (t[..., 0] for t in _mlstm_gates(p, x))
    y, st = mlstm_cell(q, k, v, logi, logf, state)
    return _output(p, x, y[:, :, None]), st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(cfg, *, generator: torch.Generator, device,
               lead: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    kw = dict(generator=generator, device=device)
    return {"wz": L.normal(lead + (d, d), d ** -0.5, **kw),
            "wi": L.normal(lead + (d, d), d ** -0.5, **kw),
            "wf": L.normal(lead + (d, d), d ** -0.5, **kw),
            "wo_g": L.normal(lead + (d, d), d ** -0.5, **kw),
            # block-diagonal recurrent weights, one [dh, dh] block per head
            "r": L.normal(lead + (h, dh, dh), dh ** -0.5, **kw),
            "wout": L.normal(lead + (d, d), d ** -0.5, **kw)}


def _slstm_gates(p: dict, x: torch.Tensor):
    """The state-free gate terms: zx, clipped log-input, log-forget and the
    output gate, f32 [..., D]."""
    lit = L.dense(x, p["wi"]).float().clamp(_LOG_EPS, 8.0)
    lft = -F.softplus(-L.dense(x, p["wf"]).float() - 1.0)
    og = torch.sigmoid(L.dense(x, p["wo_g"]).float())
    return L.dense(x, p["wz"]).float(), lit, lft, og


def _slstm_cell(r: torch.Tensor, zx, lit, lft, og, state: dict) -> dict:
    """One step of the sLSTM recurrence on [B, D] rows."""
    b, d = zx.shape
    h, dh = r.shape[0], r.shape[1]
    rh = torch.einsum("bhk,hkv->bhv", state["h"].reshape(b, h, dh),
                      r).reshape(b, d)
    zt = torch.tanh(zx + rh)
    lfm = lft + state["m"]
    m2 = torch.maximum(lfm, lit)
    i_ = torch.exp(lit - m2)
    f_ = torch.exp(lfm - m2)
    c2 = f_ * state["c"] + i_ * zt
    n2 = f_ * state["n"] + i_
    h2 = og * c2 / torch.clamp(n2, min=1.0)
    return {"c": c2, "n": n2, "h": h2, "m": m2}


def slstm_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, L, D] -> [B, L, D]; a sequential loop over time."""
    b, l, d = x.shape
    zx, lit, lft, og = _slstm_gates(p, x)
    r = p["r"].float()
    st = slstm_init_state(b, d, device=x.device)
    hs = []
    for t in range(l):
        st = _slstm_cell(r, zx[:, t], lit[:, t], lft[:, t], og[:, t], st)
        hs.append(st["h"])
    y = torch.stack(hs, 1).to(x.dtype)
    return L.dense(y, p["wout"])


def slstm_init_state(b: int, d: int, *, lead: tuple = (),
                     device=None) -> dict:
    z = lambda: torch.zeros(lead + (b, d), dtype=torch.float32,  # noqa: E731
                            device=device)
    return {"c": z(), "n": z(), "h": z(), "m": z()}


def slstm_step(p: dict, x: torch.Tensor, state: dict):
    """Single-token decode.  x [B, 1, D] -> ([B, 1, D], state')."""
    zx, lit, lft, og = _slstm_gates(p, x[:, 0])
    st = _slstm_cell(p["r"].float(), zx, lit, lft, og, state)
    return L.dense(st["h"].to(x.dtype), p["wout"])[:, None], st
