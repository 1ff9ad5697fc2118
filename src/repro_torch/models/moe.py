"""Mixture-of-Experts with sort-based dispatch.

The port of `repro/models/moe.py`: token-choice top-k routing with static
capacity.  Tokens are the vertices of a bipartite graph, (token, expert)
assignments its edges; dispatch ships token vectors to the assignment
sites and the combine sums each token's assignments (DESIGN.md §5).

  route:    the router's f32 logits -> each token's k best experts (a
            stable descending sort: on a tie the lower expert first, as
            `jax.lax.top_k` orders them), their gates (the softmax of the
            k logits) -> the assignments sorted stably by expert -> each
            one's position in its expert's buffer (`searchsorted`), kept
            below the capacity;
  dispatch: the token vectors, in the payload dtype, written into
            [n_experts, capacity, d] buffers; assignments past capacity
            are dropped;
  experts:  bf16 `torch.bmm` products (the reference's einsums, which no
            Pallas kernel carries);
  combine:  each token's k gate-weighted outputs added in f32 one at a
            time from zero, in ascending expert order: the order in which
            the reference's scatter-add (`zeros.at[tok].add`) applies them
            (`combine`).

No step adds into memory out of order, forward or backward: there is no
`index_add_`, no scatter-add and no accumulating index put here.  Dispatch
and combine move rows between the assignments, laid out token by token
(`token_order`), and the buffer slots: each slot holds at most one
assignment and each assignment at most one slot, so both directions are
gathers (`_Take`), with the inverse map as the backward's gather.  The
dispatch reads each token k times through `repeat_interleave`, whose
backward sums the k rows.  (A gather whose autograd scatters back would
send every dropped assignment's zero cotangent to one slot: a serial run
of thousands of rows in PyTorch's indexing backward, 20 ms a layer at
moonshot's training shape on the H100.)

The gates equal the reference's bit for bit: `_Exp` reproduces the f32
exp that XLA compiles on the CPU and the softmax sums its k terms from left
to right, as XLA does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.ref import pow2
from . import perf
from .layers import BF16, dense, normal


def init_moe(cfg, *, generator: torch.Generator, device,
             lead: tuple = ()) -> dict:
    """router [d, ne], wi/wg [ne, d, f], wo [ne, f, d] (f32); `lead`
    stacks layers on leading axes."""
    d, f, ne = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    kw = dict(generator=generator, device=device)
    return {"router": normal(lead + (d, ne), d ** -0.5, **kw),
            "wi": normal(lead + (ne, d, f), d ** -0.5, **kw),
            "wg": normal(lead + (ne, d, f), d ** -0.5, **kw),
            "wo": normal(lead + (ne, f, d), f ** -0.5, **kw)}


# ---------------------------------------------------------------------------
# Gates: the reference's softmax, with XLA's f32 exp
# ---------------------------------------------------------------------------
_F = lambda v: float(np.float32(v))  # noqa: E731  (an f32 constant)
_LOG2E, _C1, _C2 = _F(1.44269504088896341), _F(0.693359375), \
    _F(-2.12194440e-4)
_P = [_F(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                      4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)]
_EXP_LO, _EXP_HI = _F(-88.3762626647949), _F(88.3762626647950)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c as one fused multiply-add: the product of two f32
    values is exact in f64, so only the f64 sum rounds before f32 does."""
    return (a * b + c).float().double()


class _Exp(torch.autograd.Function):
    """f32 exp as XLA computes it on the CPU: Cephes' polynomial, its
    multiply-adds fused (it matched on 10^6 inputs in [-15, 0]).  The
    gradient is g * exp(x), as for any exp."""

    @staticmethod
    def forward(ctx, x):
        x = x.double().clamp(_EXP_LO, _EXP_HI)
        n = torch.floor(_fma(x, _LOG2E, 0.5))
        a = _fma(n, -_C2, _fma(n, -_C1, x))
        z = (a * a).float().double()
        y = _fma(a, _P[0], _P[1])
        for c in _P[2:]:
            y = _fma(y, a, c)
        y = (_fma(y, z, a) + 1.0).float()
        out = y * pow2(n.to(torch.int32))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * out


def _softmax(v: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` over the last axis of f32 v [T, k] (k small): exp
    of v - max, then divided by the sum of its terms taken left to right."""
    e = _Exp.apply(v - v.max(-1, keepdim=True).values.detach())
    s = e[:, 0]
    for j in range(1, e.shape[-1]):
        s = s + e[:, j]
    return e / s[:, None]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
class Routing(NamedTuple):
    experts: torch.Tensor   # [T, k] each token's experts, best first
    gates: torch.Tensor     # [T, k] f32, their softmax weights
    order: torch.Tensor     # [T*k] assignments (t * k + j) sorted by expert
    pos: torch.Tensor       # [T*k] each sorted assignment's buffer slot
    keep: torch.Tensor      # [T*k] pos < capacity
    capacity: int


def route(logits: torch.Tensor, top_k: int,
          capacity_factor: float) -> Routing:
    """Top-k routing of f32 router logits [T, n_experts]."""
    n_tok, ne = logits.shape
    vals, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    experts = experts[:, :top_k]
    gates = _softmax(vals[:, :top_k])
    # position of each assignment within its expert, stable by token order
    exp_idx = experts.reshape(-1)
    order = torch.argsort(exp_idx, stable=True)
    exp_sorted = exp_idx[order]
    first = torch.searchsorted(exp_sorted, exp_sorted, side="left")
    pos = torch.arange(n_tok * top_k, device=logits.device) - first
    # slots per expert: at least 4, rounded up to a multiple of 4
    cap = max(int(capacity_factor * n_tok * top_k / ne), 4)
    cap = -(-cap // 4) * 4
    return Routing(experts, gates, order, pos, pos < cap, cap)


def token_order(order: torch.Tensor, top_k: int) -> torch.Tensor:
    """The sorted assignments (`order`'s positions) token by token, each
    token's k in their order there (ascending expert): row t * k + m of
    the combine's layout is sorted assignment `token_order(...)[t * k + m]`."""
    return torch.argsort(order // top_k, stable=True)


def combine(contrib: torch.Tensor, top_k: int) -> torch.Tensor:
    """out [T, d]: token t's rows t * k .. t * k + k - 1 of contrib [T*k, d]
    (the `token_order` layout) added one at a time from zero.  Bit for bit
    the reference's `zeros.at[order // k].add(contrib_sorted)`, which
    applies each token's updates in `order`'s sequence."""
    c = contrib.view(-1, top_k, contrib.shape[-1])
    out = torch.zeros_like(c[:, 0])
    for m in range(top_k):
        out = out + c[:, m]
    return out


class _Take(torch.autograd.Function):
    """out[i] = x[idx[i]], or zeros where idx[i] == len(x), for an idx that
    takes each row of x at most once; `inv` is its inverse (inv[r] = the i
    with idx[i] == r, or len(out) for a row not taken).  So the backward is
    the gather g[inv] and adds nothing anywhere."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _pad(x)[idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _pad(g)[inv], None, None


def _pad(x: torch.Tensor) -> torch.Tensor:
    """x [n, d] with a row of zeros appended at index n."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------
def _moe_tokens(p: dict, w: dict, xt: torch.Tensor, cfg,
                capacity_factor: float, pay_dtype):
    """Top-k MoE over a flat token table xt [T, d], with the expert weights
    `w` in bf16.  Returns ([T, d], dropped assignments, capacity)."""
    n_tok, d = xt.shape
    ne, k = cfg.n_experts, cfg.top_k
    r = route(dense(xt, p["router"]).float(), k, capacity_factor)
    cap, n_slots, nk = r.capacity, ne * r.capacity, n_tok * k
    # each assignment's buffer slot in the combine's layout (n_slots:
    # dropped), and each slot's row there (nk: empty); the dropped rows'
    # writes all land on the trash entry n_slots
    by_token = token_order(r.order, k)
    exp_sorted = r.experts.reshape(-1)[r.order]
    slot_c = torch.where(r.keep, exp_sorted * cap + r.pos, n_slots)[by_token]
    row_of = torch.full((n_slots + 1,), nk, device=xt.device).index_put_(
        (slot_c,), torch.arange(nk, device=xt.device))[:n_slots]

    # dispatch: row t * k + m of the repeated table is token t
    xs = xt.to(pay_dtype).repeat_interleave(k, 0)
    dbuf = _Take.apply(xs, row_of, slot_c).view(ne, cap, d)
    dbuf = perf.constrain(dbuf, "moe_dispatch_spec").to(BF16)

    h = torch.nn.functional.silu(torch.bmm(dbuf, w["wg"])) * \
        torch.bmm(dbuf, w["wi"])
    y = perf.constrain(torch.bmm(h, w["wo"]), "moe_dispatch_spec")

    # combine: each assignment's output (zeros where dropped), weighted by
    # its gate, summed token by token
    got = _Take.apply(y.view(n_slots, d), slot_c, row_of)
    gate = r.gates.reshape(-1)[r.order][by_token]
    out = combine(got.float() * gate[:, None], k)
    return out.to(xt.dtype), (~r.keep).sum(), cap


def moe_block(p: dict, x: torch.Tensor, cfg, *,
              capacity_factor: float = 1.25):
    """x [B, L, d] -> ([B, L, d], {"dropped", "capacity"}): top-k
    token-choice routing over all B * L tokens, or, under the perf option
    `moe_groups`, over each batch row alone with its own capacity."""
    b, l, d = x.shape
    capacity_factor = perf.get("moe_capacity_factor", capacity_factor)
    pay_dtype = perf.get("moe_payload_dtype", x.dtype)
    w = {n: p[n].to(BF16) for n in ("wi", "wg", "wo")}
    if perf.get("moe_groups"):
        rows = [_moe_tokens(p, w, xr, cfg, capacity_factor, pay_dtype)
                for xr in x]
        return (torch.stack([o for o, _, _ in rows]),
                {"dropped": torch.stack([dr for _, dr, _ in rows]).sum(),
                 "capacity": rows[0][2]})
    out, dropped, cap = _moe_tokens(p, w, x.reshape(b * l, d), cfg,
                                    capacity_factor, pay_dtype)
    return out.reshape(b, l, d), {"dropped": dropped, "capacity": cap}
