"""How a routed exchange buffer moves (the port of `repro.core.transport`).

`core/wire.py` decides what a `[nl, P, K, ...]` exchange buffer looks like
on the wire; this module decides how it moves.  Every transport keeps the
routed-ship contract

    ship(tree, flags) -> (recv_tree, recv_flags)      with
    recv_tree[p, q, j] == tree[q, p, j]   wherever  recv_flags[p, q, j]:

  * **Dense**: the exchange's transpose through the codec; the whole static
    buffer moves and stale entries ship as zeros.
  * **Ragged**: the active entries of each destination are compacted into
    a `[nl, P, cap, ...]` payload with `[nl, P, cap]` slot indices and
    per-destination counts, shipped through the same codec (its blocks
    tile the compacted payload) and scattered back into the dense layout.
    Entries past `cap` would be lost, so a destination that overflows its
    capacity sends the whole ship dense.

The choice is made on two timescales, as in the reference: inside one
superstep the device picks dense or ragged from the overflow check and the
caller's hysteresis (`prefer_ragged`), without a host sync: both branches
run and each receive buffer is selected with `torch.where`, since a CUDA
graph replays one fixed sequence of kernels.  Across the host-driven
supersteps of `pregel`, `adapt_policy` re-plans the static capacity from
the occupancy the previous superstep observed.

`pipeline=True` moves every buffer through `ring_transpose`, P stage copies
bit-identical to the transpose.  The broadcast lane (`allgather_ship`)
moves high-replication mirrors once per source through `all_gather_rows`.

With `TransportPolicy.integrity` every ship carries a per-route int32
integrity word (`wire.integrity_word`), recomputed at receive: a failed
check retries the ship once, and a second failure degrades the route to
the raw dense transpose for the superstep.  The reference picks its rungs
with `lax.cond`; here every checked ship runs attempt 0, attempt 1 and the
degrade rung, and the device selects by the verdicts, so a captured
superstep reads nothing back (the reference's trace visits all three
rungs too, so a fault injector sees the same calls and attempt marks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import wire as wire_mod
from .tree import (ElemSpec, bmask, scatter_rows, tree_flatten, tree_leaves,
                   tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TransportPolicy:
    """Static transport plan (hashable: one capture per distinct plan).

    kind: "dense" | "ragged" | "auto".  "dense" and "ragged" force their
    plan (ragged still falls back on overflow unless `fallback=False`);
    "auto" switches per superstep on the dirty fraction with hysteresis,
    and `pregel` re-plans its capacities on the host.  Fields keep the
    reference's order: policies are built by position."""

    kind: str = "dense"
    # per-destination capacity of the ragged buffer; None derives it as
    # ceil(K * capacity_frac) rounded up to cap_rounding
    cap: int | None = None
    capacity_frac: float = 0.5
    # the aggregate-return route's own fraction (None: capacity_frac)
    capacity_frac_back: float | None = None
    # capacities round up to a multiple of this, the tier quantum too
    cap_rounding: int = 32
    # hysteresis band on the dirty fraction: ragged below enter_frac,
    # dense again above exit_frac
    enter_frac: float = 0.35
    exit_frac: float = 0.5
    # above this capacity fraction the slot-index wire costs more than the
    # payload it saves: capacity_for answers dense
    ragged_max_frac: float = 0.65
    # overflow -> dense fallback.  False ships ragged unconditionally: only
    # for callers that certify the capacity
    fallback: bool = True
    # ship through the ring-pipelined transpose (bit-identical)
    pipeline: bool = False
    # adapt_policy's shrink headroom: a tier steps down only when the
    # occupancy clears the lower tier after this factor
    tier_headroom: float = 1.25
    # per-route integrity words checked at receive: retry once, then ship
    # the route raw and dense (scaled codecs ship unchecked)
    integrity: bool = False
    # per-destination capacity tiers (a length-P tuple of fractions)
    capacity_fracs: tuple | None = None
    capacity_fracs_back: tuple | None = None

    def replace(self, **kw) -> "TransportPolicy":
        return dataclasses.replace(self, **kw)


DENSE = TransportPolicy("dense")
RAGGED = TransportPolicy("ragged")
AUTO = TransportPolicy("auto")

TRANSPORT_NAMES = ("dense", "ragged", "auto")


def resolve_transport(spec) -> TransportPolicy:
    """None | "dense" | "ragged" | "auto" | TransportPolicy -> policy."""
    if spec is None:
        return DENSE
    if isinstance(spec, TransportPolicy):
        return spec
    try:
        return {"dense": DENSE, "ragged": RAGGED, "auto": AUTO}[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown transport {spec!r}; one of {TRANSPORT_NAMES}") from None


def ragged_plan(spec, active) -> TransportPolicy | None:
    """A ragged-capable policy, or None when the ship is dense anyway (no
    plan, the dense plan, or no active mask to compact)."""
    if spec is None or active is None:
        return None
    tp = resolve_transport(spec)
    return tp if tp.kind != "dense" else None


def capacity_for(policy: TransportPolicy, k: int) -> int | None:
    """Per-destination capacity of a K-wide route, or None when the ragged
    plan cannot beat the dense wire (the capacity clears the break-even
    fraction)."""
    if policy.kind == "dense" or k <= 0:
        return None
    cap = (policy.cap if policy.cap is not None
           else int(np.ceil(k * policy.capacity_frac)))
    r = max(int(policy.cap_rounding), 1)
    cap = max(-(-int(cap) // r) * r, r)
    if policy.capacity_fracs:
        # tiered: the buffer is sized by the tallest tier, the break-even
        # is judged on the mean tier (what each destination really pays)
        eff = float(np.mean([min(float(f), 1.0)
                             for f in policy.capacity_fracs]))
        return None if eff >= policy.ragged_max_frac else min(cap, k)
    return None if cap >= k * policy.ragged_max_frac else cap


def capacity_vec_for(policy: TransportPolicy, k: int, p: int,
                     cap: int | None) -> np.ndarray | None:
    """Per-destination capacities [P] of the tiered lane, or None when the
    plan is untiered.  Each fraction rounds up to its own cap_rounding
    multiple and clips to `cap`, the width of the uniform buffer."""
    if cap is None or policy.capacity_fracs is None:
        return None
    if len(policy.capacity_fracs) != p:
        return None
    r = max(int(policy.cap_rounding), 1)
    caps = [min(max(-(-int(np.ceil(k * float(f))) // r) * r, r), cap)
            for f in policy.capacity_fracs]
    return np.asarray(caps, dtype=np.int32)


def round_capacity(policy: TransportPolicy, count: int) -> int:
    """An observed occupancy rounded up to the policy's capacity tier."""
    r = max(int(policy.cap_rounding), 1)
    return max(-(-max(int(count), 1) // r) * r, r)


# host-side capacity fractions quantize to 1/8 tiers: at most 8 distinct
# ragged plans per route over a run, each captured once
FRAC_TIERS = 8


def frac_tier(frac: float, tiers: int = FRAC_TIERS) -> float:
    """An occupancy fraction rounded up to the next 1/tiers step."""
    return min(float(np.ceil(max(frac, 0.0) * tiers)) / tiers, 1.0)


def adapt_policy(policy: TransportPolicy, *, was_ragged: bool,
                 active_frac: float, fwd_frac, back_frac=None,
                 prev: TransportPolicy | None = None) -> TransportPolicy:
    """Host-side re-plan of an "auto" policy for the next superstep; a
    concrete "dense" or "ragged" policy (any other kind passes through).

    Hysteresis on the active fraction picks dense or ragged; each ship's
    capacity is the previous superstep's occupancy rounded up one 1/8
    tier.  `prev` (the concrete policy just run) pins tiers: growth applies
    at once, a tier steps down only when the occupancy clears the lower
    tier after `tier_headroom`.  fwd_frac / back_frac are a scalar
    (route-wide) or a length-P per-destination vector, which plans
    `capacity_fracs` with the hysteresis pinned per destination."""
    if policy.kind != "auto":
        return policy
    thresh = policy.exit_frac if was_ragged else policy.enter_frac
    if active_frac > thresh:
        return policy.replace(kind="dense")
    prev_ragged = prev is not None and prev.kind == "ragged"

    def tier(frac: float, prev_t: float | None) -> float:
        t = frac_tier(frac)
        if prev_t is None or t > prev_t:
            return t
        return min(frac_tier(min(frac * policy.tier_headroom, 1.0)), prev_t)

    def as_vec(f):
        if f is None or np.ndim(f) == 0:
            return None
        return [float(x) for x in np.asarray(f, dtype=np.float64).ravel()]

    def tier_vec(fracs, prev_vec, prev_scalar):
        out = []
        for i, f in enumerate(fracs):
            pt = None
            if prev_ragged:
                pv = (prev_vec if prev_vec is not None
                      and len(prev_vec) == len(fracs) else None)
                pt = pv[i] if pv is not None else prev_scalar
            out.append(tier(f, pt))
        return tuple(out)

    fv, bv = as_vec(fwd_frac), as_vec(back_frac)
    if fv is None:
        fwd_vec = None
        fwd_t = fwd_eff = tier(float(fwd_frac),
                               prev.capacity_frac if prev_ragged else None)
    else:
        fwd_vec = tier_vec(fv, prev.capacity_fracs if prev_ragged else None,
                           prev.capacity_frac if prev_ragged else None)
        # the largest tier sizes the buffer, the mean decides break-even
        fwd_t = max(fwd_vec)
        fwd_eff = sum(fwd_vec) / len(fwd_vec)
    if back_frac is None:
        back_vec = back_t = back_eff = None
    elif bv is None:
        back_vec = None
        back_t = back_eff = tier(
            float(back_frac), prev.capacity_frac_back if prev_ragged else None)
    else:
        back_vec = tier_vec(
            bv, prev.capacity_fracs_back if prev_ragged else None,
            prev.capacity_frac_back if prev_ragged else None)
        back_t = max(back_vec)
        back_eff = sum(back_vec) / len(back_vec)
    # neither ship clears the break-even clamp: the ragged plan would run
    # dense anyway, so plan dense and save the capture
    if fwd_eff >= policy.ragged_max_frac and (
            back_eff is None or back_eff >= policy.ragged_max_frac):
        return policy.replace(kind="dense")
    return policy.replace(kind="ragged", cap=None, capacity_frac=fwd_t,
                          capacity_frac_back=back_t,
                          capacity_fracs=fwd_vec,
                          capacity_fracs_back=back_vec)


# ---------------------------------------------------------------------------
# Route-ship log: every routed ship records one event per Python call, so
# the events of one call are its route collectives.  A replayed superstep
# adds the events its capture recorded (`core.capture.Replay`), as it adds
# its launch counts.  Reset by the caller; bounded (the oldest half drops
# past the cap).
# ---------------------------------------------------------------------------
SHIP_EVENTS: list = []
_SHIP_EVENTS_CAP = 65536


def record_ship(label: str, kind: str, route: str) -> None:
    """Log one routed ship.  label: "fwd" | "back" | a caller's tag."""
    if len(SHIP_EVENTS) >= _SHIP_EVENTS_CAP:
        del SHIP_EVENTS[:_SHIP_EVENTS_CAP // 2]
    SHIP_EVENTS.append({"label": label, "kind": kind, "route": route})


class TransportInfo(NamedTuple):
    """Facts about one routed ship: Python numbers where the plan is
    static, 0-d tensors where the device chose the branch."""

    bytes_shipped: Any      # what the collectives really moved
    ragged: Any             # 0/1: the branch taken
    overflow: Any           # 0/1: a count exceeded its capacity
    route_active_max: Any   # int32: the largest per-destination count
    wire_faults: Any = 0.0  # integrity-check failures (retried or degraded)
    degraded: Any = 0.0     # routes shipped raw after a failed retry
    # [P] f32 per-destination occupancy (max over rows of counts / K)
    route_active_frac: Any = 0.0


def index_dtype(k: int) -> np.dtype:
    """Narrowest signed dtype addressing a K-wide route (the slot-index
    wire is always packed, whatever the codec)."""
    return wire_mod.int_wire_dtype(np.int32, max(k - 1, 1))


def _const_vec(values, device) -> torch.Tensor:
    """An int32 tensor of host values, made by fills: no host-to-device
    copy, so a captured superstep may build it."""
    out = torch.empty((len(values),), dtype=torch.int32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(int(v))
    return out


def _compact(tree, flags: torch.Tensor, cap: int):
    """Compact each destination's active entries, in ascending slot order
    (the reference's stable argsort of ~flags, taken to `cap`): payload
    [nl, P, cap, ...], slot indices [nl, P, cap] int32, validity, counts.
    The running count of active entries places them: the j-th kept entry
    is the first slot where the count reaches j (a binary search a lane),
    so no sort, no host sync, and no two lanes write one address.
    Invalid positions hold zeros (their slot index is never read)."""
    nl, p, k = flags.shape
    counts = flags.sum(-1, dtype=torch.int32)  # [nl, P]
    running = torch.cumsum(flags, -1, dtype=torch.int32)  # [nl, P, K]
    lanes = torch.arange(cap, dtype=torch.int32, device=flags.device)
    sel = torch.searchsorted(
        running, (lanes + 1).expand(nl, p, cap).contiguous()).clamp_(
            max=k - 1).to(torch.int32)
    valid = lanes < counts[..., None]

    def take(x):
        tail = tuple(x.shape[3:])
        idx = sel.long().reshape(sel.shape + (1,) * len(tail)).expand(
            (nl, p, cap) + tail)
        got = torch.gather(x, 2, idx)
        return got.masked_fill(~bmask(valid, got), 0)
    return tree_map(take, tree), sel, valid, counts


def _scatter_rows(leaf: torch.Tensor, idx: torch.Tensor, k: int):
    """[nl, P, cap, ...] rows back into [nl, P, K, ...] zeros; entries with
    idx >= K drop."""
    nl, p, cap = idx.shape
    tail = tuple(leaf.shape[3:])
    flat = leaf.reshape((nl * p, cap) + tail)
    init = leaf.new_zeros((nl * p, k) + tail)
    out = scatter_rows(init, idx.reshape(nl * p, cap), flat)
    return out.reshape((nl, p, k) + tail)


def _dense_wire_bytes(tree, codec, bound, flags_shipped: bool) -> int:
    """Bytes the dense collectives move: the codec's payload and block
    exponents, plus one flag byte per entry when the flags ride a
    collective (incremental ships; full ships rebuild them from the
    route's structure)."""
    leaves = tree_leaves(tree)
    total = wire_mod.static_wire_bytes(tree, codec, bound)
    if flags_shipped and leaves:
        nl, p, k = leaves[0].shape[:3]
        total += nl * p * k
    return total


def ragged_wire_bytes(tree, codec, bound, cap: int,
                      capvec: np.ndarray | None = None) -> int:
    """Bytes the ragged collectives move for one routed ship: compacted
    payload (and block exponents), slot indices and counts.  With a
    per-destination `capvec` each destination pays its own tier."""
    leaves = tree_leaves(tree)
    if not leaves:
        return 0
    nl, p, k = leaves[0].shape[:3]
    isz = index_dtype(k).itemsize

    def spec(width: int, c: int):
        return tree_map(lambda x: ElemSpec((nl, width, c) + tuple(x.shape[3:]),
                                           x.dtype), tree)
    if capvec is None:
        payload = wire_mod.static_wire_bytes(spec(p, cap), codec, bound)
        return payload + nl * p * cap * isz + nl * p * 4
    total = nl * p * 4
    for c in (int(x) for x in capvec):
        total += wire_mod.static_wire_bytes(spec(1, c), codec, bound) \
            + nl * c * isz
    return total


def _ring_tree_ship(ex, tree, *, active=None, bound: int | None = None):
    """`Exchange.tree_ship` over the ring-pipelined transpose: encode each
    leaf, move payload and block exponents through `ring_transpose`,
    decode.  The same values as the plain ship."""
    def one(x):
        enc = wire_mod.encode_leaf(x, ex.codec, bound=bound, active=active)
        if enc is None:
            return ex.ring_transpose(x)
        payload = ex.ring_transpose(enc.payload)
        scale = None if enc.scale is None else ex.ring_transpose(enc.scale)
        return wire_mod.decode_leaf(enc.kind, payload, scale, x, ex.codec)
    return tree_map(one, tree)


def _ship_once(ex, tree, flags: torch.Tensor, *, bound: int | None = None,
               policy: TransportPolicy = DENSE,
               prefer_ragged: torch.Tensor | None = None,
               recvflags: torch.Tensor | None = None):
    """One pass of the routed ship.  Returns (recv_tree, recv_flags,
    TransportInfo)."""
    codec = ex.codec
    xpose = ex.ring_transpose if policy.pipeline else ex.transpose

    def tship(t, active):
        if policy.pipeline:
            return _ring_tree_ship(ex, t, active=active, bound=bound)
        return ex.tree_ship(t, active=active, bound=bound)

    nl, p, k = flags.shape
    if not tree_leaves(tree):
        rf = recvflags if recvflags is not None else xpose(flags)
        return tree, rf, TransportInfo(
            0, 0.0, 0.0, 0, route_active_frac=torch.zeros(
                (p,), dtype=torch.float32, device=flags.device))
    counts = flags.sum(-1, dtype=torch.int32)
    maxc = counts.max()
    # per-destination occupancy, the vector adapt_policy tiers on: times
    # the f32 reciprocal of K, as the reference's compiled superstep has it
    # (XLA turns the division by a constant into that product), so the
    # tiers planned from it are the reference's
    frac_vec = counts.amax(0).float() * float(np.float32(1.0 / max(k, 1)))

    def ship_dense():
        recv = tship(tree, flags)
        rf = recvflags if recvflags is not None else xpose(flags)
        return recv, rf

    cap = capacity_for(policy, k)
    dense_bytes = _dense_wire_bytes(tree, codec, bound,
                                    flags_shipped=recvflags is None)
    if cap is None:
        recv, rf = ship_dense()
        return recv, rf, TransportInfo(dense_bytes, 0.0, 0.0, maxc,
                                       route_active_frac=frac_vec)

    idx_dt = wire_mod._TORCH_INT[np.dtype(index_dtype(k))]
    capvec = capacity_vec_for(policy, k, p, cap)
    rag_bytes = ragged_wire_bytes(tree, codec, bound, cap, capvec=capvec)
    cv = None if capvec is None else _const_vec(capvec, flags.device)
    lanes = torch.arange(cap, dtype=torch.int32, device=flags.device)

    def ship_ragged():
        comp, sel, valid, cnt = _compact(tree, flags, cap)
        if cv is not None:
            # tiered: entries past a destination's tier are not on the
            # wire, so the bytes accounted are the bytes delivered
            cnt = torch.minimum(cnt, cv[None, :])
            valid = lanes < cnt[..., None]
            comp = tree_map(lambda c: c.masked_fill(~bmask(valid, c), 0),
                            comp)
        recv_comp = tship(comp, valid)
        sel_t = xpose(torch.where(valid, sel, 0).to(idx_dt))
        cnt_t = xpose(cnt[..., None])[..., 0]
        valid_t = lanes < cnt_t[..., None]
        idx = torch.where(valid_t, sel_t.to(torch.int32), k)   # k: drop
        recv = tree_map(lambda leaf: _scatter_rows(leaf, idx, k), recv_comp)
        return recv, _scatter_rows(valid_t, idx, k)

    # a destination over ITS tier falls back, even under the uniform cap
    overflow = (maxc > cap if cv is None
                else (counts > cv[None, :]).any())
    if not policy.fallback:
        recv, rf = ship_ragged()
        return recv, rf, TransportInfo(rag_bytes, 1.0, overflow.float(),
                                       maxc, route_active_frac=frac_vec)

    over_any = ex.psum(overflow.to(torch.int32)) > 0
    use_ragged = ~over_any
    if prefer_ragged is not None:
        use_ragged = use_ragged & prefer_ragged.to(torch.bool)
    # both branches run and each buffer is selected on the device (the
    # reference's lax.cond): a replayed graph has one fixed kernel order
    # and must not read the decision back to the host.  Ragged first, the
    # order the reference traces its branches in (a fault injector counts
    # the collectives)
    recv_r, rf_r = ship_ragged()
    recv_d, rf_d = ship_dense()
    recv = tree_map(lambda r, d: torch.where(use_ragged, r, d), recv_r, recv_d)
    rf = torch.where(use_ragged, rf_r, rf_d)
    bytes_shipped = torch.where(use_ragged, float(rag_bytes),
                                float(dense_bytes))
    return recv, rf, TransportInfo(bytes_shipped, use_ragged.float(),
                                   over_any.float(), maxc,
                                   route_active_frac=frac_vec)


def ship_transport(ex, tree, flags: torch.Tensor, *, bound: int | None = None,
                   policy: TransportPolicy = DENSE,
                   prefer_ragged: torch.Tensor | None = None,
                   recvflags: torch.Tensor | None = None):
    """Move one routed [nl, P, K, ...] buffer through the selected
    transport.  Returns (recv_tree, recv_flags, TransportInfo).

    flags [nl, P, K] bool: the entries the receiver must observe (the
    wire's active set: the others may arrive as zeros).  prefer_ragged: a
    0-d bool tensor, the caller's hysteresis (None: ragged whenever it
    fits).  recvflags: receive-side flags known from the route's structure
    (full ships), which spare the dense path the flags collective.

    With `policy.integrity` the ship carries a per-route word, a
    position-weighted fold over the decoded payload bits and the flags,
    salted with the destination and sender ids, recomputed at receive.
    A mismatch anywhere (psummed: uniform over the mesh) retries the ship;
    a second one degrades the route to a raw full-width dense transpose.
    Values stay exact, `wire_faults` / `degraded` count the events, and
    the extra attempts' bytes land in `bytes_shipped`."""
    kw = dict(bound=bound, policy=policy, prefer_ragged=prefer_ragged,
              recvflags=recvflags)
    if not policy.integrity or not tree_leaves(tree):
        return _ship_once(ex, tree, flags, **kw)
    codec = ex.codec
    # a fault injector brackets its corruption by these attempt marks; a
    # real executor has no hook
    note = getattr(ex, "note_attempt", lambda _a: None)
    if not wire_mod.verifiable(codec):
        note(0)
        return _ship_once(ex, tree, flags, **kw)

    xpose = ex.ring_transpose if policy.pipeline else ex.transpose
    nl, p, k = flags.shape
    dev = flags.device
    # the send side folds what an intact receiver materialises
    rt = tree_map(lambda x: wire_mod.roundtrip_leaf(
        x, codec, bound=bound, active=flags), tree)
    cols = torch.arange(p, dtype=torch.int32, device=dev).expand(nl, p)
    rows = ex.home_rows(nl, device=dev)[:, None].expand(nl, p)
    expect = wire_mod.integrity_word(rt, flags, dest=cols, src=rows)

    def attempt(a: int):
        note(a)
        recv, rf, info = _ship_once(ex, tree, flags, **kw)
        want = xpose(expect[..., None])[..., 0]
        got = wire_mod.integrity_word(recv, rf, dest=rows, src=cols)
        bad = (got != want).sum(dtype=torch.int32)
        # uniform over the mesh: one device's mismatch retries everywhere
        return recv, rf, info, ex.psum(bad) == 0

    # every rung runs; the device selects (the reference's two lax.conds)
    recv0, rf0, info0, ok0 = attempt(0)
    recv_a, rf_a, info_a, ok_a = attempt(1)
    recv1 = tree_map(lambda x, y: torch.where(ok0, x, y), recv0, recv_a)
    rf1 = torch.where(ok0, rf0, rf_a)
    ok1 = ok0 | ok_a

    def pick(f):
        return torch.where(ok0, _f32(getattr(info0, f), dev),
                           _f32(getattr(info_a, f), dev))

    # last rung: the raw full-width dense transpose, nothing left to
    # mis-encode, cast back to the kept rung's dtypes
    note(2)
    recv_d = tree_map(lambda x, l: xpose(x).to(l.dtype), tree, recv1)
    rf_d = recvflags if recvflags is not None else xpose(flags)
    recv2 = tree_map(lambda x, y: torch.where(ok1, x, y), recv1, recv_d)
    rf2 = torch.where(ok1, rf1, rf_d)

    raw_bytes = float(sum(x.numel() * x.element_size()
                          for x in tree_leaves(tree)))
    if recvflags is None:
        raw_bytes += nl * p * k
    word_bytes = float(nl * p * 4)
    retried = (~ok0).float()
    degraded = (~ok1).float()
    # f32 in the reference's order
    bytes_shipped = (_f32(info0.bytes_shipped, dev)
                     + retried * pick("bytes_shipped")
                     + degraded * raw_bytes
                     + (1.0 + retried) * word_bytes)
    info = TransportInfo(
        bytes_shipped=bytes_shipped,
        ragged=torch.where(degraded > 0, 0.0, pick("ragged")),
        overflow=torch.maximum(_f32(info0.overflow, dev),
                               _f32(info_a.overflow, dev)),
        route_active_max=info0.route_active_max,
        wire_faults=retried + degraded, degraded=degraded,
        route_active_frac=info0.route_active_frac)
    return recv2, rf2, info


def _f32(x, device) -> torch.Tensor:
    """A 0-d f32 tensor of a Python number or tensor (a fill, no
    host-to-device copy: a captured superstep may make it)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Broadcast lane: high-replication mirrors ship once per source
# ---------------------------------------------------------------------------
def allgather_wire_bytes(staged, codec, bound, p: int,
                         flags_shipped: bool) -> int:
    """Bytes the broadcast lane's all-gather injects: each home partition
    contributes its [nl, 1, B, ...] block once (a ring lowering would
    traverse P-1 links with it; `bytes_link_modeled` counts that)."""
    total = wire_mod.static_wire_bytes(staged, codec, bound)
    if flags_shipped:
        leaves = tree_leaves(staged)
        if leaves:
            nl, _one, b = leaves[0].shape[:3]
            total += nl * b
    return int(total)


def _as_bytes(x: torch.Tensor, nl: int) -> torch.Tensor:
    """[nl, ...] tensor -> [nl, nbytes] uint8, its exact bit pattern."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8).reshape(nl, -1)
    return x.contiguous().view(torch.uint8).reshape(nl, -1)


def allgather_ship(ex, tree, flags: torch.Tensor, *, bound: int | None = None,
                   recvflags: torch.Tensor | None = None,
                   integrity: bool = False):
    """Move one broadcast block [nl, B, ...] through the all-gather: every
    home partition contributes its block once and every partition receives
    all of them.  Returns (recv_tree [nl, P, B, ...], recv_flags [nl, P, B],
    TransportInfo), with recv_tree[l, q, j] == tree_global[q, j] wherever
    recv_flags[l, q, j].

    The block is staged as [nl, 1, B, ...] through the codec, so its
    quantisation blocks tile B as a routed buffer's do, and every encoded
    leaf and the send flags are packed into ONE uint8 buffer (bits
    reinterpreted, not converted): one collective a ship.  With
    `integrity` each source block carries one word (no destination salt:
    a broadcast goes everywhere; the sender salt is checked against the
    block's column), with the routed ships' retry and degrade rungs."""
    codec = ex.codec
    p = ex.p
    nl, b = flags.shape
    dev = flags.device
    zfrac = torch.zeros((p,), dtype=torch.float32, device=dev)
    leaves, treedef = tree_flatten(tree)
    if not leaves or b == 0:
        rf = (recvflags if recvflags is not None
              else ex.all_gather_rows(flags))
        return (tree_map(ex.all_gather_rows, tree), rf,
                TransportInfo(0, 0.0, 0.0, 0, route_active_frac=zfrac))

    ship_flags = recvflags is None

    def ship():
        bufs, metas = [], []
        for x in leaves:
            enc = wire_mod.encode_leaf(x[:, None], codec, bound=bound,
                                       active=flags[:, None])
            if enc is None:
                bufs.append(_as_bytes(x, nl))
                metas.append((None, x, None))
            else:
                pl = enc.payload[:, 0]
                sc = None if enc.scale is None else enc.scale[:, 0]
                bufs.append(_as_bytes(pl, nl))
                if sc is not None:
                    bufs.append(_as_bytes(sc, nl))
                metas.append((enc.kind, pl, sc))
        if ship_flags:
            bufs.append(flags.to(torch.uint8))
        g = ex.all_gather_rows(torch.cat(bufs, dim=-1))    # [nl, P, N]

        off = 0

        def take(like: torch.Tensor) -> torch.Tensor:
            nonlocal off
            tail = tuple(like.shape[1:])
            nb = int(np.prod(tail, dtype=np.int64)) * like.element_size()
            seg = g[..., off:off + nb]
            off += nb
            if like.dtype == torch.bool:
                return seg.reshape((nl, p) + tail).to(torch.bool)
            seg = seg.contiguous().reshape((nl, p) + tail
                                           + (like.element_size(),))
            return seg.view(like.dtype).reshape((nl, p) + tail)

        out = []
        for (kind, first, sc), x in zip(metas, leaves):
            if kind is None:
                out.append(take(x))
                continue
            payload = take(first)
            scale = None if sc is None else take(sc)
            out.append(wire_mod.decode_leaf(
                kind, payload, scale,
                ElemSpec((nl, p) + tuple(x.shape[1:]), x.dtype), codec))
        recv = tree_unflatten(out, treedef)
        rf = (g[..., off:off + b].reshape(nl, p, b).to(torch.bool)
              if ship_flags else recvflags)
        return recv, rf

    staged = tree_map(lambda x: ElemSpec((nl, 1) + tuple(x.shape[1:]),
                                         x.dtype), tree)
    ag_bytes = allgather_wire_bytes(staged, codec, bound, p,
                                    flags_shipped=ship_flags)
    maxc = flags.sum(-1, dtype=torch.int32).max()
    note = getattr(ex, "note_attempt", lambda _a: None)
    if not integrity or not wire_mod.verifiable(codec):
        if integrity:
            note(0)
        recv, rf = ship()
        return recv, rf, TransportInfo(ag_bytes, 0.0, 0.0, maxc,
                                       route_active_frac=zfrac)

    flags3 = flags[:, None]                                  # [nl, 1, B]
    rt = tree_map(lambda x: wire_mod.roundtrip_leaf(
        x[:, None], codec, bound=bound, active=flags3), tree)
    rows = ex.home_rows(nl, device=dev)[:, None]              # [nl, 1]
    expect = wire_mod.integrity_word(
        rt, flags3, dest=torch.full((nl, 1), -1, dtype=torch.int32,
                                    device=dev), src=rows)
    cols = torch.arange(p, dtype=torch.int32, device=dev).expand(nl, p)
    no_dest = torch.full((nl, p), -1, dtype=torch.int32, device=dev)

    def attempt(a: int):
        note(a)
        recv, rf = ship()
        want = ex.all_gather_rows(expect)[..., 0]            # [nl, P]
        got = wire_mod.integrity_word(recv, rf, dest=no_dest, src=cols)
        return recv, rf, ex.psum((got != want).sum(dtype=torch.int32)) == 0

    recv0, rf0, ok0 = attempt(0)
    recv_a, rf_a, ok_a = attempt(1)
    recv1 = tree_map(lambda x, y: torch.where(ok0, x, y), recv0, recv_a)
    rf1 = torch.where(ok0, rf0, rf_a)
    ok1 = ok0 | ok_a
    note(2)
    recv_d = tree_map(lambda x, l: ex.all_gather_rows(x).to(l.dtype), tree,
                      recv1)
    rf_d = recvflags if recvflags is not None else ex.all_gather_rows(flags)
    recv2 = tree_map(lambda x, y: torch.where(ok1, x, y), recv1, recv_d)
    rf2 = torch.where(ok1, rf1, rf_d)
    raw_bytes = float(sum(x.numel() * x.element_size() for x in leaves))
    if recvflags is None:
        raw_bytes += float(nl * b)
    retried = (~ok0).float()
    degraded = (~ok1).float()
    info = TransportInfo(
        bytes_shipped=((1.0 + retried) * float(ag_bytes)
                       + degraded * raw_bytes
                       + (1.0 + retried) * float(nl * 4)),
        ragged=0.0, overflow=0.0, route_active_max=maxc,
        wire_faults=retried + degraded, degraded=degraded,
        route_active_frac=zfrac)
    return recv2, rf2, info
