"""mrTriplets execution: the physical join + aggregation plan (paper §4.4–4.6).

Logical plan: triplets = edges ⋈ vertices(src) ⋈ vertices(dst); messages =
map(triplets); result = reduceByKey(messages).  Physical plan, as in
`repro.core.mrtriplets`:

  1. join elimination (§4.5.2): the UDF trace picks the routing table
     ("src" / "dst" / "both" / none) and the vertex leaves it reads;
  2. vertex shipping through the graph-resident view (§4.5.1): only dirty
     leaves and missing directions move, over the dense transport and
     through the exchange's wire codec (`core/wire.py`); under a resident
     codec the mirrors stay encoded between supersteps (§2.4);
  3. the edge map + local aggregation, either fused — one CUDA kernel
     gathers both endpoints, runs the UDF and reduces into mirror slots
     (kernels/triplet.py; it reads encoded mirrors through their scale
     plane) — or unfused: gather, vmapped UDF, segment reduce
     (kernels/segment_sum.py for float sums);
  4. the aggregate return over the same routes, combined at the homes in
     ascending source-partition order, or handed raw to the fused Pregel
     apply (kernels/superstep.py).

Each aggregation side walks the edges in its own order, `s.agg_perm[to]`
(None for the stored, dst-sorted order; `src_perm` for "src" on a built
graph; `reverse()` swaps the two), so the CSR tables `agg_ptr[to]` and the
messages both plans reduce agree on a transposed graph too.

Scope: dense transport; the fused plans take leaves of rank <= 1, with f16
staged through f32 and bf16 mirrors staged as bf16 when every used leaf is
bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from . import analysis
from . import transport as transport_mod
from . import wire as wire_mod
from .tree import (ElemSpec, bmask, elem_spec, gather_rows, nbytes_of,
                   scatter_rows, tree_flatten, tree_leaves, tree_map,
                   tree_unflatten, tree_zeros_like_elem, vmap2)
from ..kernels import ops as kops
from ..kernels import udf
from ..kernels.ref import SCALE_GROUP
from ..kernels.superstep import MAX_DM as MAX_APPLY_DM, ApplyUdf
from ..kernels.triplet import TripletUdf

# min/max fusion width cap, kept from the reference so plan decisions agree
FUSED_MINMAX_MAX_WIDTH = 64
# f32 mantissa: integers round-trip the kernels' f32 staging below this
_INT_STAGE_BOUND = 1 << 24


def reduce_identity(reduce: str, dtype: torch.dtype):
    """The engine's identity of `reduce` in `dtype` (finite extremes)."""
    if reduce == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


@dataclasses.dataclass(frozen=True)
class ViewCache:
    """One ship's materialised view slice (the record ship_to_mirrors
    consumes and produces; `core.view.GraphView` drives it)."""

    mirror: Any              # pytree [nl, V_mir, ...]
    filled: torch.Tensor     # [nl, V_mir] bool — slot has ever been shipped
    active: torch.Tensor     # [nl, V_mir] bool — slot changed in this ship


@dataclasses.dataclass(frozen=True)
class ShipMetrics:
    """Byte accounting of route ships (the reference's dense-wire fields)."""

    wire_bytes: int                  # static bytes a dense collective moves
    effective_bytes: torch.Tensor    # data actually needed
    n_shipped: torch.Tensor          # route entries that carried a value
    bytes_accounted: Any             # codec accounting: int, or an int64
    #                                  tensor under a delta codec
    bytes_shipped: int               # what the transport really moved
    route_width: int                 # K of the route
    bytes_link_modeled: float        # ring-lowered link bytes

    @classmethod
    def zero(cls, device=None) -> "ShipMetrics":
        zi = torch.zeros((), dtype=torch.int64, device=device)
        return cls(0, zi, zi, 0, 0, 0, 0.0)

    def merge(self, other: "ShipMetrics") -> "ShipMetrics":
        """Bytes and counts add; the route width takes the max."""
        return ShipMetrics(
            wire_bytes=self.wire_bytes + other.wire_bytes,
            effective_bytes=self.effective_bytes + other.effective_bytes,
            n_shipped=self.n_shipped + other.n_shipped,
            bytes_accounted=self.bytes_accounted + other.bytes_accounted,
            bytes_shipped=self.bytes_shipped + other.bytes_shipped,
            route_width=max(self.route_width, other.route_width),
            bytes_link_modeled=(self.bytes_link_modeled
                                + other.bytes_link_modeled))

    def to_host(self) -> dict:
        """Python numbers, for per-superstep records."""
        return {f.name: (v.item() if isinstance(v, torch.Tensor) else v)
                for f in dataclasses.fields(self)
                for v in (getattr(self, f.name),)}


def _route_ship(ex, sendbuf: Any, flags: torch.Tensor, *, bound: int | None,
                elem_bytes: int, recvflags: torch.Tensor | None = None):
    """Move one routed [nl, P, K, ...] buffer + its flags (the wire's
    active set) through the codec and account it."""
    recvbuf, rflags, shipped = transport_mod.ship_transport(
        ex, sendbuf, flags, bound=bound, recvflags=recvflags)
    p = flags.shape[1]
    n = flags.sum()
    metrics = ShipMetrics(
        wire_bytes=wire_mod.static_wire_bytes(sendbuf, ex.codec, bound),
        effective_bytes=n * elem_bytes, n_shipped=n,
        bytes_accounted=wire_mod.bytes_on_wire(sendbuf, ex.codec, flags,
                                               bound),
        bytes_shipped=shipped,
        route_width=flags.shape[-1],
        # a2a on a ring: each chip's diagonal block never leaves it
        bytes_link_modeled=shipped * (p - 1) / max(p, 1))
    return recvbuf, rflags, metrics


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [nl, N, ...], idx [nl, P, K] (clipped) -> [nl, P, K, ...]."""
    nl, p, k = idx.shape
    return gather_rows(t, idx.reshape(nl, p * k)).reshape(
        (nl, p, k) + tuple(t.shape[2:]))


def ship_to_mirrors(s, values: Any, need: str, ex, *,
                    active: torch.Tensor | None = None,
                    cache: ViewCache | None = None, bound: int | None = None):
    """Materialise the replicated vertex view for one need set.

    values: pytree [nl, V_blk, ...]; active [nl, V_blk] ships only those
    rows (None: every routed row); bound: |value| bound of lossless int
    narrowing.  A narrow-resident cache is decoded for the scatter and the
    result re-encoded once after it: untouched blocks round-trip exactly,
    blocks a fresh row landed in re-quantize against their new absmax.
    Returns (ViewCache, ShipMetrics)."""
    if s.has_bcast:
        raise NotImplementedError(
            "the broadcast lane (bcast_min_repl) is not ported yet")
    send_idx, recv_slot = s.routes[need]
    nl, p, k = send_idx.shape
    valid = send_idx >= 0
    safe_idx = send_idx.clamp(min=0)
    elem_bytes = nbytes_of(tree_map(lambda v: v[0, 0], values))

    flags = valid if active is None else valid & _take_rows(active, safe_idx)
    sendbuf = tree_map(lambda v: _take_rows(v, safe_idx), values)
    # (masked_fill keeps a bool leaf, the visibility mask, bool on the wire)
    sendbuf = tree_map(lambda b: b.masked_fill(~bmask(flags, b), 0), sendbuf)

    # full ship: the receiver knows the flags from the route's structure
    structural = (recv_slot < s.v_mir) if active is None else None
    recvbuf, recvflags, metrics = _route_ship(
        ex, sendbuf, flags, bound=bound, elem_bytes=elem_bytes,
        recvflags=structural)

    # incremental scatter: only fresh entries overwrite their mirror slot
    idx = torch.where(recvflags, recv_slot, s.v_mir).reshape(nl, -1)
    init = (wire_mod.decode_tree(cache.mirror) if cache is not None
            else tree_map(lambda l: l.new_zeros(
                (nl, s.v_mir) + tuple(l.shape[3:])), recvbuf))
    mirror = tree_map(
        lambda b, leaf: scatter_rows(
            b, idx, leaf.reshape((nl, p * k) + tuple(leaf.shape[3:]))),
        init, recvbuf)
    shipped = scatter_rows(
        torch.zeros((nl, s.v_mir), dtype=torch.bool, device=idx.device), idx,
        torch.ones((nl, p * k), dtype=torch.bool, device=idx.device))
    codec = ex.codec
    if codec is not None and codec.resident:
        def encode(leaf):
            kind = wire_mod.resident_kind(leaf.dtype, codec, bound)
            return (wire_mod.encode_resident(leaf, codec, kind, bound=bound)
                    if kind else leaf)
        mirror = tree_map(encode, mirror)
    filled = shipped if cache is None else (cache.filled | shipped)
    return ViewCache(mirror=mirror, filled=filled, active=shipped), metrics


def ship_aggregates_home(s, partial: Any, had_msg: torch.Tensor, need: str,
                         reduce: str, ex, *, combine: bool = True,
                         bound: int | None = None):
    """Return partial aggregates [nl, V_mir, ...] to the vertex homes and
    combine them.  Float sums combine in f32 in ascending source partition
    — one partition's route entries hit distinct home rows, so each step is
    a collision-free add and the order is fixed (the fused apply reproduces
    it).  combine=False returns the raw routed buffer (recv [nl, P, K, ...],
    rflags [nl, P, K]) for the fused apply.

    The return wire zero-substitutes the entries the homes discard before
    the codec (an int identity would wrap a narrowed cast, a float one blow
    up a block's absmax); `bound` certifies message values, which partial
    sums escape, so sum aggregates never pack."""
    send_idx, recv_slot = s.routes[need]
    nl, p, k = send_idx.shape
    backbuf = tree_map(lambda leaf: _take_rows(leaf, recv_slot), partial)
    backflags = _take_rows(had_msg, recv_slot) & (recv_slot < s.v_mir)
    recv, rflags, metrics = _route_ship(
        ex, backbuf, backflags, bound=None if reduce == "sum" else bound,
        elem_bytes=nbytes_of(tree_map(lambda v: v[0, 0], partial)))
    if not combine:
        return recv, rflags, metrics

    v_blk = s.home_mask.shape[1]
    # home slot of each routed entry in a padded [nl, v_blk + 1] space whose
    # last column swallows the entries without a value
    rows = torch.arange(nl, device=send_idx.device)[:, None, None] * (v_blk + 1)
    slot = torch.where(rflags, send_idx, v_blk) + rows

    def combine_leaf(leaf):
        if leaf.dtype.is_floating_point:
            leaf = leaf.float()
        tail = tuple(leaf.shape[3:])
        ident = reduce_identity(reduce, leaf.dtype)
        out = torch.full((nl * (v_blk + 1),) + tail, ident, dtype=leaf.dtype,
                         device=leaf.device)
        if reduce == "sum" and leaf.dtype.is_floating_point:
            for pe in range(p):
                x = torch.where(bmask(rflags[:, pe], leaf[:, pe]),
                                leaf[:, pe], 0)
                out.index_add_(0, slot[:, pe].reshape(-1),
                               x.reshape((nl * k,) + tail))
        else:
            flat = torch.where(bmask(rflags, leaf), leaf, ident).reshape(
                (nl * p * k,) + tail)
            op = {"sum": "sum", "min": "amin", "max": "amax"}[reduce]
            out.scatter_reduce_(0, bmask(slot.reshape(-1), flat).expand_as(flat),
                                flat, op, include_self=True)
        return out.reshape((nl, v_blk + 1) + tail)[:, :v_blk].contiguous()

    out = tree_map(combine_leaf, recv)
    hit = torch.zeros(nl * (v_blk + 1), dtype=torch.int32,
                      device=send_idx.device)
    hit.index_add_(0, slot.reshape(-1), rflags.reshape(-1).int())
    exists = hit.reshape(nl, v_blk + 1)[:, :v_blk] > 0
    return out, exists, metrics


def _segment_aggregate(msgs: Any, ids: torch.Tensor, valid: torch.Tensor,
                       ptr: torch.Tensor, pieces, reduce: str,
                       kernel_mode: str):
    """Per-partition segment reduction of edge messages [nl, E, ...], in
    the aggregation side's CSR order (row pointers `ptr`, piece tables
    `pieces`), into mirror slots; float sums go through the segment_sum
    kernel."""
    nl, e = ids.shape
    v_mir = ptr.shape[1] - 1
    num_seg = nl * v_mir
    off = torch.arange(nl, dtype=torch.int32, device=ids.device)[:, None] * v_mir
    flat_ids = torch.where(valid, ids + off, num_seg).reshape(-1)

    def agg_leaf(leaf):
        if reduce == "sum" and leaf.dtype.is_floating_point:
            return kops.segment_sum(leaf, valid.contiguous(), ptr, pieces,
                                    mode=kernel_mode)
        tail = tuple(leaf.shape[2:])
        ident = reduce_identity(reduce, leaf.dtype)
        fill = torch.where(bmask(valid, leaf), leaf, ident).reshape(
            (nl * e,) + tail)
        out = torch.full((num_seg + 1,) + tail, ident, dtype=leaf.dtype,
                         device=leaf.device)
        op = {"sum": "sum", "min": "amin", "max": "amax"}[reduce]
        idx = bmask(flat_ids.long(), fill).expand_as(fill)
        out = out.scatter_reduce_(0, idx, fill, op, include_self=True)
        return out[:num_seg].reshape((nl, v_mir) + tail)

    partial = tree_map(agg_leaf, msgs)
    counts = torch.bincount(flat_ids.long(), minlength=num_seg + 1)[:num_seg]
    return partial, counts.reshape(nl, v_mir) > 0


# ---------------------------------------------------------------------------
# Fused triplet plan (kernels/triplet.py)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _FusedPlan:
    """Static packing layout of the fused triplet kernel."""

    v_used: tuple[bool, ...]      # vdata leaves packed into the x matrix
    src_used: tuple[bool, ...]
    dst_used: tuple[bool, ...]
    e_used: bool                  # whether the edge payload packs at all
    dm: int                       # packed message width
    msg_specs: tuple              # per message leaf
    msg_treedef: Any
    kernel: TripletUdf            # the UDF as the kernel runs it


def _fused_int_ok(dtype: torch.dtype, bound: int) -> bool:
    """Do integer values of `dtype` ride the kernels' f32 staging exactly?
    Narrow ints always; signed 32-bit ints under a |value| bound < 2^24
    (the graph's max vertex id by default: the id-valued convention)."""
    info = torch.iinfo(dtype)
    if info.bits <= 16:
        return True
    return info.bits <= 32 and info.min < 0 and bound < _INT_STAGE_BOUND


_STAGED_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _fused_leaf_ok(spec: ElemSpec, bound: int, reduce: str,
                   message: bool = False) -> bool:
    """Leaves of rank <= 1 (a rank-1 leaf packs one column per element)
    that ride the kernels' f32 staging exactly: f32, bf16 and f16 floats,
    or exactly-staged ints (int messages only under a value-preserving
    min/max)."""
    if len(spec.shape) > 1:
        return False
    if spec.dtype.is_floating_point:
        return spec.dtype in _STAGED_FLOATS
    if spec.dtype == torch.bool or spec.dtype.is_complex:
        return False
    if message and reduce == "sum":
        return False
    return _fused_int_ok(spec.dtype, bound)


def _width(spec: ElemSpec) -> int:
    """Packed columns of one leaf."""
    return int(np.prod(spec.shape)) if spec.shape else 1


def _col_starts(specs, used) -> list[int]:
    """First packed column of each leaf; columns advance over used leaves."""
    widths = [_width(sp) if u else 0 for sp, u in zip(specs, used)]
    return [int(c) for c in np.cumsum([0] + widths)[:-1]]


def _split_cols(mat: torch.Tensor, specs, lead: tuple) -> list:
    """Cut a packed [..., D] matrix back into leaves of `specs` shapes."""
    out, col = [], 0
    for sp in specs:
        w = _width(sp)
        out.append(mat[..., col:col + w].reshape(lead + tuple(sp.shape)))
        col += w
    return out


def _derive_need(deps, force_need: str | None) -> str | None:
    """Which vertex side(s) the physical join must ship."""
    if force_need is not None:
        return force_need
    return ("both" if (deps.uses_src and deps.uses_dst)
            else "src" if deps.uses_src
            else "dst" if deps.uses_dst else None)


def _plan_fused(g, map_fn, deps, need, reduce, force_need, vex, eex,
                payload_bound: int | None = None) -> _FusedPlan | None:
    """The fused plan of this mrTriplets, or None for the unfused path:
    sum/min/max over rank <= 1 float or exactly-staged int leaves (bf16 and
    f16 staged through f32), with a UDF the IR covers."""
    if reduce not in ("sum", "min", "max") or deps.msg_spec is None:
        return None
    bound = payload_bound if payload_bound is not None else g.s.max_vid
    msg_leaves, msg_treedef = tree_flatten(deps.msg_spec)
    if not msg_leaves or not all(
            _fused_leaf_ok(m, bound, reduce, message=True) for m in msg_leaves):
        return None
    vleaves = tree_leaves(vex)
    n = len(vleaves)
    if need is None:
        src_used = dst_used = (False,) * n
    elif (force_need is None and deps.src_leaves is not None
          and len(deps.src_leaves) == n):
        src_used, dst_used = deps.src_leaves, deps.dst_leaves
    else:
        src_used = (need in ("src", "both"),) * n
        dst_used = (need in ("dst", "both"),) * n
    v_used = tuple(su or du for su, du in zip(src_used, dst_used))
    if not all(_fused_leaf_ok(l, bound, reduce)
               for l, u in zip(vleaves, v_used) if u):
        return None
    eleaves = tree_leaves(eex)
    e_used = bool(eleaves) and (deps.uses_edge or force_need is not None)
    if e_used and not all(_fused_leaf_ok(l, bound, reduce) for l in eleaves):
        return None
    dm = sum(_width(m) for m in msg_leaves)
    if reduce != "sum" and dm > FUSED_MINMAX_MAX_WIDTH:
        return None
    # kernel inputs: column offsets advance over the PACKED (union) leaves
    col = _col_starts(vleaves, v_used)
    ecol = _col_starts(eleaves, (True,) * len(eleaves))
    inputs = ([("xs", c) if su else None for c, su in zip(col, src_used)]
              + [("ev", c) if e_used else None for c in ecol]
              + [("xd", c) if du else None for c, du in zip(col, dst_used)])
    ir = udf.lower(analysis.trace_udf(map_fn, vex, eex, vex), inputs)
    if ir is None:
        return None
    return _FusedPlan(v_used=v_used, src_used=src_used, dst_used=dst_used,
                      e_used=e_used, dm=dm, msg_specs=tuple(msg_leaves),
                      msg_treedef=msg_treedef, kernel=TripletUdf(ir, dm))


def _pack_cols(tree, used, nl: int, n: int, device,
               keep_bf16: bool = False) -> torch.Tensor:
    """Column-pack the used leaves of a [nl, N] pytree into f32 [nl, N, D];
    with keep_bf16, into bf16 when every used leaf is bf16 (a bf16 mirror:
    the kernel upcasts exactly, so results equal f32 staging while the
    packed rows halve)."""
    leaves = tree_leaves(tree) if tree is not None else []
    cols = [l.reshape(nl, n, -1) for l, u in zip(leaves, used) if u]
    if not cols:
        return torch.zeros((nl, n, 0), dtype=torch.float32, device=device)
    stage = (torch.bfloat16 if keep_bf16 and all(
        c.dtype == torch.bfloat16 for c in cols) else torch.float32)
    return torch.cat([c.to(stage) for c in cols], dim=-1)


def _pack_cols_encoded(tree, used, nl: int, n: int):
    """Column-pack narrow-resident leaves without decoding them (§2.4):
    (payload [nl, n, D] in the shared narrow dtype, scale [nl,
    ceil(n / SCALE_GROUP), D] int8), or None when the used leaves cannot
    share one encoded staging matrix (not all resident, mixed payload
    dtypes, another scale block) and the caller decodes on read.  "int"
    leaves ride with zero exponents (2^0 = 1; their payload upcasts
    exactly)."""
    if tree is None:
        return None
    sel = [l for l, u in zip(tree_leaves(tree), used) if u]
    if not sel or not all(wire_mod.is_resident(l) for l in sel):
        return None
    pdt = sel[0].payload.dtype
    if any(l.payload.dtype != pdt or l.block != SCALE_GROUP for l in sel):
        return None
    nb = max(-(-n // SCALE_GROUP), 1)
    pcols, scols = [], []
    for l in sel:
        pc = l.payload.reshape(nl, n, -1)
        pcols.append(pc)
        scols.append(torch.zeros((nl, nb, pc.shape[-1]), dtype=torch.int8,
                                 device=pc.device) if l.scale is None
                     else l.scale.reshape(nl, nb, -1))
    return torch.cat(pcols, dim=-1), torch.cat(scols, dim=-1)


def _fused_aggregate(g, mirror_tree, live, to, reduce, kernel_mode,
                     plan: _FusedPlan):
    """Gather both endpoint views, run the map UDF and segment-reduce into
    mirror slots in one kernel sweep; (partial [nl, V_mir] tree, had_msg).

    `mirror_tree` may hold narrow-resident leaves: when every used leaf
    shares one encoded layout the kernel reads the payload and its scale
    plane [nl * ceil(V_mir / 32), D], else the tree decodes on read."""
    s = g.s
    nl = live.shape[0]
    dev = live.device
    xscale = None
    enc = _pack_cols_encoded(mirror_tree, plan.v_used, nl, s.v_mir)
    if enc is not None:
        x, sc = enc
        xscale = sc.reshape(-1, sc.shape[-1]).contiguous()
    else:
        x = _pack_cols(wire_mod.decode_tree(mirror_tree), plan.v_used, nl,
                       s.v_mir, dev, keep_bf16=True)
    x = x.reshape(nl * s.v_mir, x.shape[-1]).contiguous()
    n_e = len(tree_leaves(g.edata))
    ev = _pack_cols(g.edata, (plan.e_used,) * n_e, nl, s.e_blk, dev)
    ev = ev.reshape(nl * s.e_blk, ev.shape[-1])
    out, cnt = kops.triplet(
        x, ev, s.src_slot, s.dst_slot, live.contiguous(), s.agg_ptr[to],
        s.agg_perm[to], plan.kernel, to=to, reduce=reduce, mode=kernel_mode,
        pieces=s.agg_pieces[to], xscale=xscale)
    out = out.reshape(nl, s.v_mir, plan.dm)
    had_msg = cnt.reshape(nl, s.v_mir) > 0
    leaves = []
    for leaf, spec in zip(_split_cols(out, plan.msg_specs, (nl, s.v_mir)),
                          plan.msg_specs):
        # empty slots hold the f32 identity: park 0, cast, then re-assert
        # the engine identity in the leaf's own dtype
        hm = bmask(had_msg, leaf)
        leaf = torch.where(hm, leaf, 0.0).to(spec.dtype)
        if reduce != "sum":
            leaf = torch.where(hm, leaf, reduce_identity(reduce, spec.dtype))
        leaves.append(leaf)
    return tree_unflatten(leaves, plan.msg_treedef), had_msg


def _union_need(a: str | None, b: str | None) -> str | None:
    """Union of two need sets (one ship covers both UDFs' reads)."""
    if a is None:
        return b
    if b is None or a == b:
        return a
    return "both"


def endpoint_rows(s, mirror: Any, vdata: Any, lead: tuple,
                  uses_src: bool, uses_dst: bool):
    """Each edge's source and destination rows of the mirror, decoded;
    zeros of vdata's element shapes under `lead` on a side not read."""
    zeros = tree_zeros_like_elem(vdata, lead)
    dec = wire_mod.decode_tree(mirror) if uses_src or uses_dst else None
    return (gather_rows(dec, s.src_slot) if uses_src else zeros,
            gather_rows(dec, s.dst_slot) if uses_dst else zeros)


def edge_mask(s, emask: torch.Tensor, *, vis: torch.Tensor | None = None,
              epred: Callable | None = None, mirror: Any = None,
              vdata: Any = None, edata: Any = None,
              uses: tuple[bool, bool] = (True, True)) -> torch.Tensor:
    """`emask` restricted to the edges whose endpoints are both set in the
    visibility mirror `vis` (when given) and that satisfy `epred` over the
    decoded mirror rows (when given): the one place a subgraph's
    visibility and edge predicate mask an edge."""
    if vis is not None:
        emask = (emask & gather_rows(vis, s.src_slot)
                 & gather_rows(vis, s.dst_slot))
    if epred is not None:
        sv, dv = endpoint_rows(s, mirror, vdata, tuple(emask.shape), *uses)
        emask = emask & vmap2(epred)(sv, edata, dv)
    return emask


def mr_triplets(g, map_fn: Callable, reduce: str = "sum", *, to: str = "dst",
                skip_stale: str | None = None, kernel_mode: str = "auto",
                force_need: str | None = None,
                payload_bound: int | None = None, transport: Any = None,
                epred: Callable | None = None, return_routed: bool = False):
    """Execute one mrTriplets.  Returns (values, exists, view, metrics).

    values [P, V_blk, ...] aggregated at the homes, exists [P, V_blk] bool,
    view the refreshed graph-resident GraphView.  return_routed=True stops
    after the aggregate return: values/exists are then the routed buffer
    and its flags, for the fused apply.

    epred: a `subgraph(epred=...)` predicate pushed below this mrTriplets
    (§4.4).  Its vertex reads join this call's ship (on a restricted graph
    the visibility mirror rides the same refresh), and it masks the live
    edges before the sweep; the combined edge mask (visibility and epred,
    before skip_stale) comes back as metrics["emask_pushed"].

    kernel_mode: "auto" (fused when eligible: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors), "ref" (fused when eligible,
    plain version), or "unfused" (gather -> vmapped UDF -> segment reduce,
    with the segment_sum kernel for float sums on the card)."""
    from . import view as view_mod      # view.py builds on this module
    s, ex = g.s, g.ex
    nl = g.vmask.shape[0]
    transport_mod.resolve_transport(transport)
    # wire-packing bound: an explicit payload_bound certifies every signed
    # int payload; the id-valued default (max_vid) speaks only for int32
    # ids, so it is floored at int16's own range (narrower dtypes never
    # narrow on it); max_vid 0 means unknown
    bound = (payload_bound if payload_bound is not None
             else (max(s.max_vid, np.iinfo(np.int16).max)
                   if s.max_vid > 0 else None))

    vex, eex = elem_spec(g.vdata), elem_spec(g.edata)
    deps = analysis.analyze_message_fn(map_fn, vex, eex, vex)
    need = _derive_need(deps, force_need)
    if force_need is not None:
        uses_src = uses_dst = True
        arity = 1 + (need in ("src", "both")) + (need in ("dst", "both"))
    else:
        uses_src, uses_dst = deps.uses_src, deps.uses_dst
        arity = deps.n_way
    edeps = (analysis.analyze_message_fn(epred, vex, eex, vex)
             if epred is not None else None)
    if edeps is not None:
        need = _union_need(need, _derive_need(edeps, None))
    metrics: dict[str, Any] = {"join_arity": arity, "need": need or "none"}

    # property-level join elimination: ship only the leaves the UDFs read
    flat_vals = tree_leaves(g.vdata)
    leaf_mask = (None if force_need is not None
                 else deps.read_leaf_mask(len(flat_vals)))
    if edeps is not None and leaf_mask is not None:
        em = edeps.read_leaf_mask(len(flat_vals))
        leaf_mask = (None if em is None else
                     tuple(a or b for a, b in zip(leaf_mask, em)))
    if leaf_mask is not None and (all(leaf_mask) or not any(leaf_mask)):
        leaf_mask = None
    metrics["shipped_leaves"] = (0 if need is None else
                                 sum(leaf_mask) if leaf_mask
                                 else len(flat_vals))
    metrics["transport"] = "dense"

    graph_view = g.view
    if not view_mod.compatible(graph_view, g.vdata, nl, s.v_mir):
        graph_view = None
    ships_fwd = 0
    # a pushed-down epred on a restricted graph folds the visibility ship
    # into this refresh
    with_vis = epred is not None and not g.vmask_full
    if need is not None or with_vis:
        lm = leaf_mask if need is not None else (False,) * len(flat_vals)
        view, mirror_tree, m_fwd, ships_fwd = view_mod.refresh_view(
            g, need or "both", leaf_mask=lm, with_vis=with_vis, bound=bound)
        metrics["fwd"] = m_fwd
        if need is None:
            # no vertex property read: no freshness information
            view = view.replace(active=torch.ones(
                (nl, s.v_mir), dtype=torch.bool, device=g.vmask.device))
    else:
        mirror_tree = None
        # no vertex data read: no delta information, every slot is fresh
        view = (graph_view if graph_view is not None
                else view_mod.empty_view(s, g.vdata, nl, ex.codec, bound))
        view = view.replace(active=torch.ones((nl, s.v_mir), dtype=torch.bool,
                                              device=g.vmask.device))
        metrics["fwd"] = ShipMetrics.zero(g.vmask.device)

    # skipStale (§3.2/§4.6): drop edges whose relevant endpoint is stale
    live = g.emask
    if epred is not None:
        live = edge_mask(s, live, vis=view.vis if with_vis else None,
                         epred=epred, mirror=mirror_tree, vdata=g.vdata,
                         edata=g.edata, uses=(edeps.uses_src, edeps.uses_dst))
        metrics["emask_pushed"] = live
    if skip_stale is not None:
        src_fresh = gather_rows(view.active, s.src_slot)
        dst_fresh = gather_rows(view.active, s.dst_slot)
        fresh = {"out": src_fresh, "in": dst_fresh,
                 "both": src_fresh | dst_fresh}[skip_stale]
        live = live & fresh
    metrics["live_edges"] = live.sum()

    plan = None
    if kernel_mode != "unfused":
        plan = _plan_fused(g, map_fn, deps, need, reduce, force_need,
                           vex, eex, payload_bound)
    metrics["plan"] = "fused" if plan is not None else "unfused"

    if plan is not None:
        # the view's mirror as it holds it: the kernel reads resident
        # leaves through their scale plane
        partial, had_msg = _fused_aggregate(g, mirror_tree, live, to, reduce,
                                            kernel_mode, plan)
    else:
        svals, dvals = endpoint_rows(s, mirror_tree, g.vdata, (nl, s.e_blk),
                                     uses_src, uses_dst)
        msgs = vmap2(map_fn)(svals, g.edata, dvals)
        sub_mode = "auto" if kernel_mode == "unfused" else kernel_mode
        # messages in the aggregation side's own edge order, where its CSR
        # tables delimit each slot's run
        ids = s.dst_slot if to == "dst" else s.src_slot
        agg_msgs, agg_valid = msgs, live
        perm = s.agg_perm[to]
        if perm is not None:
            perm = perm.long()
            agg_msgs = tree_map(lambda m: gather_rows(m, perm), msgs)
            ids = gather_rows(ids, perm)
            agg_valid = gather_rows(live, perm)
        partial, had_msg = _segment_aggregate(agg_msgs, ids, agg_valid,
                                              s.agg_ptr[to], s.agg_pieces[to],
                                              reduce, sub_mode)

    values, exists, m_back = ship_aggregates_home(
        s, partial, had_msg, to, reduce, ex, combine=not return_routed,
        bound=bound)
    metrics["back"] = m_back
    metrics["ships_fwd"] = ships_fwd
    metrics["ships"] = ships_fwd + 1
    metrics["bytes_on_wire"] = (metrics["fwd"].bytes_accounted
                                + m_back.bytes_accounted)
    metrics["bytes_shipped"] = (metrics["fwd"].bytes_shipped
                                + m_back.bytes_shipped)
    metrics["bytes_link_modeled"] = (metrics["fwd"].bytes_link_modeled
                                     + m_back.bytes_link_modeled)
    # device bytes the mirror carry keeps between calls (§2.4)
    metrics["mirror_hbm_bytes"] = wire_mod.resident_hbm_bytes(view.mirror)
    return values, exists, view, metrics


# ---------------------------------------------------------------------------
# Fused superstep apply plan (kernels/superstep.py)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _ApplyPlan:
    """Static packing layout of the fused apply kernel."""

    dm: int
    dv: int
    msg_specs: tuple              # per message leaf, combine dtype
    msg_treedef: Any
    v_specs: tuple                # per vdata leaf
    v_treedef: Any
    kernel: ApplyUdf


def _static_default(d, spec: ElemSpec) -> tuple | None:
    """Per packed column of a message leaf, the python value of its static
    default: a scalar spreads over the leaf's columns, an array of the
    leaf's shape gives one value a column; None for anything else."""
    if isinstance(d, (bool, int, float)):
        return (d,) * _width(spec)
    if isinstance(d, torch.Tensor):
        d = d.detach().cpu().numpy()
    if not isinstance(d, (np.ndarray, np.generic)):
        return None
    arr = np.asarray(d)
    if arr.ndim == 0:
        return (arr.item(),) * _width(spec)
    if tuple(arr.shape) == tuple(spec.shape):
        return tuple(arr.reshape(-1).tolist())
    return None


def _plan_apply(g, vprog: Callable, send_msg: Callable, reduce: str,
                changed_fn: Callable | None, default_msg: Any,
                payload_bound: int | None) -> _ApplyPlan | None:
    """The fused apply plan of a superstep, or None for the unfused apply:
    messages as the triplet plan admits them (floats combine in f32),
    rank <= 1 f32 or exactly-staged int state (read and written in its own
    dtype; narrower float state plans unfused, as in the reference, whose
    kernel would run the vprog in f32), static defaults (a scalar or an
    array of the leaf's shape: one value a column; the reference takes
    scalars only, so label propagation's [k] zeros fuse here), a vprog
    whose output specs equal the state's, and a vprog (and changed_fn) the
    IR covers."""
    s = g.s
    if reduce not in ("sum", "min", "max"):
        return None
    vex, eex = elem_spec(g.vdata), elem_spec(g.edata)
    if any(l.dtype in (torch.bfloat16, torch.float16)
           for l in tree_leaves(vex)):
        return None
    deps = analysis.analyze_message_fn(send_msg, vex, eex, vex)
    if deps.msg_spec is None:
        return None
    bound = payload_bound if payload_bound is not None else s.max_vid
    msg_leaves, msg_treedef = tree_flatten(deps.msg_spec)
    if not msg_leaves or not all(
            _fused_leaf_ok(m, bound, reduce, message=True) for m in msg_leaves):
        return None
    vleaves, vdef = tree_flatten(vex)
    if not vleaves or not all(_fused_leaf_ok(l, bound, reduce)
                              for l in vleaves):
        return None
    mspecs = tuple(ElemSpec(m.shape, torch.float32 if m.dtype.is_floating_point
                            else m.dtype) for m in msg_leaves)
    dleaves, _ = tree_flatten(default_msg)
    if len(dleaves) != len(msg_leaves):
        return None
    defaults = [_static_default(d, m) for d, m in zip(dleaves, mspecs)]
    if any(d is None for d in defaults):
        return None
    vid_spec = ElemSpec((), s.home_vid.dtype)
    tr = analysis.trace_udf(vprog, vid_spec, vex,
                            tree_unflatten(list(mspecs), msg_treedef))
    if tr is None or tr.out_spec != vdef or tr.out_leaves != tuple(vleaves):
        return None
    xcol = _col_starts(vleaves, (True,) * len(vleaves))
    mcol = _col_starts(mspecs, (True,) * len(mspecs))
    vp_ir = udf.lower(tr, [("vid", 0)] + [("x", c) for c in xcol]
                      + [("m", c) for c in mcol])
    if vp_ir is None:
        return None
    ch_ir = None
    if changed_fn is not None:
        tc = analysis.trace_udf(changed_fn, vex, vex)
        if tc is None or tc.out_leaves != (ElemSpec((), torch.bool),):
            return None
        ch_ir = udf.lower(tc, [("x", c) for c in xcol]
                          + [("new", c) for c in xcol])
        if ch_ir is None:
            return None
    dm = sum(_width(m) for m in mspecs)
    dv = sum(_width(v) for v in vleaves)
    if dm > MAX_APPLY_DM or (reduce != "sum" and dm > FUSED_MINMAX_MAX_WIDTH):
        return None
    # per packed message column: its leaf's dtype and default
    kernel = ApplyUdf(
        vprog=vp_ir, changed=ch_ir,
        msg_dtypes=tuple(udf._DTYPES[m.dtype] for m in mspecs
                         for _ in range(_width(m))),
        defaults=tuple(v for d in defaults for v in d),
        msgs=tuple((udf._DTYPES[m.dtype], tuple(m.shape)) for m in msg_leaves),
        state=tuple((udf._DTYPES[v.dtype], tuple(v.shape)) for v in vleaves))
    return _ApplyPlan(dm=dm, dv=dv, msg_specs=mspecs,
                      msg_treedef=msg_treedef, v_specs=tuple(vleaves),
                      v_treedef=vdef, kernel=kernel)


def fused_apply_home(g, recv: Any, rflags: torch.Tensor, to: str,
                     reduce: str, plan: _ApplyPlan, kernel_mode: str):
    """Home half of the fused superstep: one kernel sweep combines the
    routed aggregate leaves, runs the vprog and derives the changed mask,
    reading and writing the vertex leaves in place (a leaf the vprog
    passes through comes back as the same tensor).  Returns (new vdata
    pytree [nl, V_blk], changed [nl, V_blk] bool)."""
    s = g.s
    new, changed = kops.superstep_apply(
        tree_leaves(recv), rflags, s.routes[to][0], s.apply_rng[to],
        tree_leaves(g.vdata), s.home_vid, g.vmask, plan.kernel,
        reduce=reduce, mode=kernel_mode)
    return tree_unflatten(new, plan.v_treedef), changed


def apply_plan_of(g, vprog: Callable, send_msg: Callable, reduce: str = "sum",
                  *, changed_fn: Callable | None = None,
                  default_msg: Any = None, kernel_mode: str = "auto",
                  payload_bound: int | None = None) -> str:
    """"fused_apply" | "unfused": the apply-half plan decision."""
    if kernel_mode == "unfused":
        return "unfused"
    plan = _plan_apply(g, vprog, send_msg, reduce, changed_fn, default_msg,
                       payload_bound)
    return "fused_apply" if plan is not None else "unfused"


def fused_plan(g, map_fn: Callable, reduce: str = "sum", *,
               force_need: str | None = None,
               payload_bound: int | None = None) -> _FusedPlan | None:
    """The fused triplet plan of an mrTriplets on `g`, or None."""
    vex, eex = elem_spec(g.vdata), elem_spec(g.edata)
    deps = analysis.analyze_message_fn(map_fn, vex, eex, vex)
    return _plan_fused(g, map_fn, deps, _derive_need(deps, force_need),
                       reduce, force_need, vex, eex, payload_bound)


def plan_of(g, map_fn: Callable, reduce: str = "sum", *,
            kernel_mode: str = "auto", force_need: str | None = None,
            payload_bound: int | None = None) -> str:
    """"fused" | "unfused": the physical-plan decision of an mrTriplets."""
    if kernel_mode == "unfused":
        return "unfused"
    plan = fused_plan(g, map_fn, reduce, force_need=force_need,
                      payload_bound=payload_bound)
    return "fused" if plan is not None else "unfused"
