"""Chain-level relational optimizer over declared operator chains (§4.4).

Each `mrTriplets`, `mapE` and `subgraph` plans its own ships.  This module
plans a declared chain of them as one query:

  1. Whole-chain join elimination: each step's refresh request (which
     leaves, over which route directions) is accumulated backward with
     `analysis.union_read_dirs`, and before each step `view.prune_view`
     forgets the per-leaf view state no remaining step requests.  A dirty
     leaf read only through `src` downstream stops shipping its dst
     coherence; a dirty leaf never read again stops shipping.
  2. Predicate pushdown: a `Subgraph(vpred/epred)` followed by a
     `MrTriplets` lowers into `mr_triplets(epred=...)`: one refresh covers
     the predicate's and the message UDF's reads (and the visibility
     ship), and the predicate masks the live edges the triplet kernel
     sweeps.
  3. Host-adaptive transport: between steps `transport.adapt_policy`
     re-plans a `kind="auto"` policy from the route occupancy of the ship
     just run and the view's dirty fraction, as `pregel`'s driver does a
     superstep.

Planning changes ships, never values: pruning only reduces what the view
claims is filled (an unanticipated read takes the cold full-ship path),
clean leaves are never demoted, `skip_stale` is a planning barrier (its
freshness marks couple values to the ship plan), and transports are
value-free.  Planning reads element specs only, from the UDF traces of
`core/analysis.py`; a trace that fails plans "keep everything".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import analysis
from . import transport as transport_mod
from . import view as view_mod
from .mrtriplets import _derive_need, _union_need
from .tree import (ElemSpec, elem_spec, tree_flatten_with_path, tree_leaves,
                   tree_unflatten, vmap2)

_DIR = {"src": "s", "dst": "d", "both": "sd"}


# ------------------------------------------------------------- chain steps
@dataclasses.dataclass(frozen=True)
class MapV:
    """g.mapV(f, changed=...)"""
    f: Callable
    changed: Any = None


@dataclasses.dataclass(frozen=True)
class MapE:
    """g.mapE(f)"""
    f: Callable


@dataclasses.dataclass(frozen=True)
class Subgraph:
    """g.subgraph(vpred, epred): pushes below a following MrTriplets."""
    vpred: Callable | None = None
    epred: Callable | None = None


@dataclasses.dataclass(frozen=True)
class MrTriplets:
    """g.mrTriplets(map_fn, reduce, ...): produces one chain output."""
    map_fn: Callable
    reduce: str = "sum"
    to: str = "dst"
    skip_stale: str | None = None
    kernel_mode: str = "auto"
    payload_bound: int | None = None


def _true_epred(sv, ev, dv):
    """Vacuous predicate that carries a vpred-only Subgraph's visibility
    restriction through the pushdown path (module-level: fused caches key
    on UDF identity)."""
    return torch.tensor(True)


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Static decisions for one declared chain."""
    # per step: per-flat-vdata-leaf direction set any step >= i requests
    # ("" | "s" | "d" | "sd"), or None: unknown, prune nothing there
    keep_dirs: tuple
    # step i is a Subgraph folded into the MrTriplets at i + 1
    fused: tuple


@dataclasses.dataclass
class ChainResult:
    graph: Any          # the graph after the whole chain
    outputs: list       # (values, exists, metrics) per MrTriplets step
    step_metrics: list  # per-step planner records (host-side facts)


# ----------------------------------------------------------- static analysis
def _mrt_request(map_fn, epred, vex, eex, n):
    """The per-leaf direction set a (possibly predicate-fused) mrTriplets
    refresh requests, or None when unknown (a trace failed)."""
    deps = analysis.analyze_message_fn(map_fn, vex, eex, vex)
    need = _derive_need(deps, None)
    mask = deps.read_leaf_mask(n)
    if epred is not None:
        edeps = analysis.analyze_message_fn(epred, vex, eex, vex)
        need = _union_need(need, _derive_need(edeps, None))
        em = edeps.read_leaf_mask(n)
        mask = (None if mask is None or em is None
                else tuple(a or b for a, b in zip(mask, em)))
    if need is None:
        return ("",) * n
    if mask is None:
        return None
    return tuple(_DIR[need] if m else "" for m in mask)


def _out_spec(fn, *arg_specs):
    """The ElemSpec pytree `fn` returns on these element specs, or None
    when it does not trace."""
    tr = analysis.trace_udf(fn, *arg_specs)
    return None if tr is None else tree_unflatten(list(tr.out_leaves),
                                                  tr.out_spec)


def _paths(tree) -> list:
    return [p for p, _ in tree_flatten_with_path(tree)[0]]


def plan_chain(g, steps, *, optimize: bool = True) -> ChainPlan:
    """Statically analyze a chain against this graph's property specs.
    Reads element specs only, never values.  Unknown territory (a UDF that
    does not trace, a structure-changing mapV) plans keep-everything,
    never a wrong plan."""
    steps = tuple(steps)
    ns = len(steps)
    fused = [False] * ns
    if optimize:
        for i in range(ns - 1):
            st, nxt = steps[i], steps[i + 1]
            if (isinstance(st, Subgraph) and isinstance(nxt, MrTriplets)
                    and (st.epred is not None or st.vpred is not None)
                    and nxt.skip_stale is None):
                fused[i] = True

    # forward pass: the property element specs entering each step (mapV
    # and mapE may retype); a spec that cannot be derived poisons the rest
    vid_spec = ElemSpec((), g.s.home_vid.dtype)
    cur_v, cur_e = elem_spec(g.vdata), elem_spec(g.edata)
    specs, carry_ok = [], []
    known = True
    for st in steps:
        specs.append((cur_v, cur_e) if known else None)
        ok = True
        if known and isinstance(st, MapV):
            new_v = _out_spec(st.f, vid_spec, cur_v)
            if new_v is None:
                known = False
            else:
                # leaf indices line up across the rewrite only when the
                # flattened paths do; otherwise no read set crosses it
                ok = _paths(cur_v) == _paths(new_v)
                cur_v = new_v
        elif known and isinstance(st, MapE):
            cur_e = _out_spec(st.f, cur_v, cur_e, cur_v)
            known = cur_e is not None
        carry_ok.append(ok and known)

    # backward pass: per-leaf directions requested by steps >= i, starting
    # from "nothing is read after the chain": the declared chain is the
    # caller's certificate of the remaining consumers (a read outside it
    # cold-ships: bytes, not values)
    keep: list = [None] * ns
    tail: tuple | None = ()
    for i in range(ns - 1, -1, -1):
        st = steps[i]
        if specs[i] is None:
            keep[i] = None
            tail = None
            continue
        vex, eex = specs[i]
        n = len(tree_leaves(vex))
        req_tail = ("",) * n if tail == () else tail
        if isinstance(st, MrTriplets):
            if i > 0 and fused[i - 1]:
                req = ("",) * n   # accounted at the Subgraph it fused with
            else:
                req = _mrt_request(st.map_fn, None, vex, eex, n)
            if st.skip_stale is not None:
                req = None        # a barrier: nothing at or before it prunes
        elif isinstance(st, Subgraph):
            if fused[i]:
                req = _mrt_request(steps[i + 1].map_fn,
                                   st.epred or _true_epred, vex, eex, n)
            elif st.epred is not None:
                em = analysis.analyze_message_fn(
                    st.epred, vex, eex, vex).read_leaf_mask(n)
                req = None if em is None else tuple("sd" if m else ""
                                                    for m in em)
            else:
                req = ("",) * n
        elif isinstance(st, MapE):
            req = _mrt_request(st.f, None, vex, eex, n)
        else:   # MapV reads home values only, never the mirror
            req = ("",) * n
        fut = analysis.union_read_dirs(req, req_tail)
        if isinstance(st, MapV) and not carry_ok[i]:
            # downstream reads name the post-rewrite leaves, which do not
            # map onto the leaves the view holds before this step
            fut = None
        keep[i] = fut if optimize else None
        tail = fut
    return ChainPlan(keep_dirs=tuple(keep), fused=tuple(fused))


# ----------------------------------------------------------------- execution
def _effective_keep(view, keep):
    """Never demote a clean leaf: it ships nothing within the chain either
    way, so pruning it could only tax readers after the chain."""
    if view is None or keep is None or len(keep) != len(view.dirs):
        return None
    return tuple(d if not st else k
                 for k, d, st in zip(keep, view.dirs, view.stale))


def _apply_vpred(g, vpred):
    """The local half of subgraph(vpred): restrict visibility and dirty
    the flipped visibility rows; the ship rides the fused mrTriplets."""
    vmask = g.vmask & vmap2(vpred)(g.s.home_vid, g.vdata)
    view = g.view.mark_vis(g.vmask ^ vmask) if g.view is not None else None
    return g.replace(vmask=vmask, view=view, active=g.active & vmask,
                     vmask_full=False)


def _host_floats(*xs) -> list[float]:
    """Python floats of tensors and numbers, in one host read."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if dev is None:
        return [float(x) for x in xs]
    return torch.stack([torch.as_tensor(x, device=dev).float().reshape(())
                        for x in xs]).tolist()


def run_chain(g, steps, *, optimize: bool = True, transport: Any = None
              ) -> ChainResult:
    """Execute a declared operator chain through the optimizer.

    optimize=False runs the steps exactly as the method chain would (the
    differential baseline: the same values, maybe more bytes).  transport
    follows the mrTriplets contract; "auto" re-plans on the host between
    steps from the route occupancy, the dirty rows and the visible count,
    read once a step."""
    steps = tuple(steps)
    plan = plan_chain(g, steps, optimize=optimize)
    tp_spec = transport_mod.resolve_transport(transport)
    cur_tp = transport_mod.DENSE if tp_spec.kind == "auto" else tp_spec
    outputs: list = []
    recs: list = []
    i = 0
    while i < len(steps):
        st = steps[i]
        rec: dict[str, Any] = {"step": i, "kind": type(st).__name__,
                               "transport": cur_tp.kind}
        if optimize:
            keep = _effective_keep(g.view, plan.keep_dirs[i])
            pruned = view_mod.prune_view(g.view, keep)
            rec["pruned_dirs"] = (
                0 if g.view is None or pruned is g.view else
                sum(len(a) - len(b)
                    for a, b in zip(g.view.dirs, pruned.dirs)))
            if pruned is not g.view:
                g = g.replace(view=pruned)
        m = None
        if isinstance(st, Subgraph) and plan.fused[i]:
            nxt = steps[i + 1]
            if st.vpred is not None:
                g = _apply_vpred(g, st.vpred)
            vals, ok, g, m = g.mrTriplets(
                nxt.map_fn, nxt.reduce, to=nxt.to,
                skip_stale=nxt.skip_stale, kernel_mode=nxt.kernel_mode,
                payload_bound=nxt.payload_bound, transport=cur_tp,
                epred=st.epred or _true_epred)
            rec["pushdown"] = True
            outputs.append((vals, ok, m))
            i += 2
        elif isinstance(st, MrTriplets):
            vals, ok, g, m = g.mrTriplets(
                st.map_fn, st.reduce, to=st.to, skip_stale=st.skip_stale,
                kernel_mode=st.kernel_mode, payload_bound=st.payload_bound,
                transport=cur_tp)
            outputs.append((vals, ok, m))
            i += 1
        elif isinstance(st, Subgraph):
            g = g.subgraph(st.vpred, st.epred)
            i += 1
        elif isinstance(st, MapE):
            g = g.mapE(st.f)
            i += 1
        elif isinstance(st, MapV):
            g = g.mapV(st.f, changed=st.changed)
            i += 1
        else:
            raise TypeError(f"unknown chain step {st!r}")

        # each figure over the whole group (a multi-process executor's
        # ranks must plan alike): occupancies by maximum, counts by sum
        ex = g.ex
        if tp_spec.kind == "auto" and m is not None:
            fwd, back = m["fwd"], m["back"]
            rows = view_mod.dirty_rows(g.view)
            dev = g.vmask.device
            occ, back_occ, af, nvis, bs = _host_floats(
                ex.pmax(torch.as_tensor(fwd.route_active_max, device=dev)),
                ex.pmax(torch.as_tensor(back.route_active_max, device=dev)),
                ex.psum(torch.as_tensor(0 if rows is None else rows.sum(),
                                        device=dev)),
                ex.psum(g.vmask.sum()), ex.psum(g.bytes_shipped))
            cur_tp = transport_mod.adapt_policy(
                tp_spec, was_ragged=cur_tp.kind == "ragged",
                active_frac=af / max(nvis, 1.0),
                fwd_frac=occ / max(fwd.route_width, 1),
                back_frac=back_occ / max(back.route_width, 1))
            rec["transport_next"] = cur_tp.kind
        else:
            bs = float(ex.psum(g.bytes_shipped))
        rec["bytes_shipped_total"] = bs
        recs.append(rec)
    return ChainResult(graph=g, outputs=outputs, step_metrics=recs)
