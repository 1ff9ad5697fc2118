"""Recurrent sequence mixing: xLSTM's mLSTM (matrix memory) and sLSTM, and
Griffin's RG-LRU.

The port of `repro/models/recurrent.py`, with the reference's casts: bf16
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
* RG-LRU, full sequence: the diagonal recurrence h_t = a_t h_{t-1} + b_t
  as `jax.lax.associative_scan`'s recursion on the time axis (`_scan`),
  step for step, so autograd saves O(L) pairs and no time loop runs.
* RG-LRU, one token: `rglru_step`, the reference's step.
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


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------
def init_rglru(cfg, *, generator: torch.Generator, device,
               lead: tuple = ()) -> dict:
    d, dr = cfg.d_model, cfg.d_recurrent
    kw = dict(generator=generator, device=device)
    return {"w_in": L.normal(lead + (d, dr), d ** -0.5, **kw),
            "w_gate": L.normal(lead + (d, dr), d ** -0.5, **kw),
            "conv_w": L.normal(lead + (4, dr), 0.25, **kw),
            "wr": L.normal(lead + (dr, dr), dr ** -0.5, **kw),
            "wi": L.normal(lead + (dr, dr), dr ** -0.5, **kw),
            "lam": torch.ones(lead + (dr,), dtype=torch.float32,
                              device=device),
            "w_out": L.normal(lead + (dr, d), dr ** -0.5, **kw)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs on dim 1 under (a1, b1) o (a2, b2) =
    (a1 a2, a2 b1 + b2), in `jax.lax.associative_scan`'s order: combine
    the pairs (0,1), (2,3), ...; scan those; combine each result but the
    last with the next even input; prepend element 0; interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _scan(a[:, 0:-1:2] * a[:, 1::2],
                   a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    stop = -1 if n % 2 == 0 else None
    ea = torch.cat([a[:, :1], oa[:, :stop] * a[:, 2::2]], 1)
    eb = torch.cat([b[:, :1], a[:, 2::2] * ob[:, :stop] + b[:, 2::2]], 1)

    def interleave(even, odd):
        out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
        out[:, 0::2] = even
        out[:, 1::2] = odd
        return out

    return interleave(ea, oa), interleave(eb, ob)


def _rglru_core(p: dict, u: torch.Tensor, h0: torch.Tensor | None = None):
    """The gated linear recurrence over u [B, L, Dr] -> h [B, L, Dr] f32."""
    r = torch.sigmoid(L.dense(u, p["wr"]).float())
    i = torch.sigmoid(L.dense(u, p["wi"]).float())
    log_a = -8.0 * r * _softplus(p["lam"].float())              # <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * u.float())
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None],
                           gated[:, 1:]], 1)
    return _scan(a, gated)[1]


def rglru_block(p: dict, x: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """Griffin's recurrent block: (gelu gate) x (width-4 causal conv, then
    the RG-LRU), out projection.  x [B, L, D] -> [B, L, D]."""
    u = L.dense(x, p["w_in"])
    gate = F.gelu(L.dense(x, p["w_gate"]).float(), approximate="tanh")
    upad = F.pad(u, (0, 0, 3, 0))
    w = p["conv_w"].to(u.dtype)
    conv = sum(upad[:, 3 - j:upad.shape[1] - j] * w[3 - j] for j in range(4))
    h = _rglru_core(p, conv, h0)
    return L.dense((gate * h).to(x.dtype), p["w_out"])


def rglru_init_state(b: int, dr: int, *, lead: tuple = (),
                     device=None) -> dict:
    return {"h": torch.zeros(lead + (b, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (b, 3, dr), dtype=torch.float32,
                                device=device)}


def rglru_step(p: dict, x: torch.Tensor, state: dict):
    """Single-token decode.  x [B, 1, D] -> ([B, 1, D], state')."""
    xt = x[:, 0]
    u = L.dense(xt, p["w_in"]).float()
    gate = F.gelu(L.dense(xt, p["w_gate"]).float(), approximate="tanh")
    hist = torch.cat([state["conv"], u[:, None]], 1)          # [B, 4, Dr]
    conv = torch.einsum("bjd,jd->bd", hist, p["conv_w"].float())
    r = torch.sigmoid(conv @ p["wr"].float())
    i = torch.sigmoid(conv @ p["wi"].float())
    log_a = -8.0 * r * _softplus(p["lam"].float())
    h2 = torch.exp(log_a) * state["h"] + torch.sqrt(torch.clamp(
        1 - torch.exp(2 * log_a), min=1e-6)) * (i * conv)
    out = L.dense((gate * h2).to(x.dtype), p["w_out"])
    return out[:, None], {"h": h2, "conv": hist[:, 1:]}
