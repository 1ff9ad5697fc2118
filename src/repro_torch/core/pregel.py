"""Enhanced Pregel on the GAS decomposition (paper §3.3, Listing 5).

Per superstep:
    msgs   = g.mrTriplets(send_msg, gather, skipStale)   # scatter + gather
    vdata' = vprog(vid, vdata, msg_or_default)           # apply
    active = changed(vdata, vdata')                      # vote to halt
until no vertex changed or max_supersteps.

As in the reference host loop: the incremental view rides the graph, the
changed mask feeds it back per leaf (passthrough leaves never re-ship), and
`fuse_apply="auto"` runs the combine + vprog + changed half as one kernel
(kernels/superstep.py) whenever the shapes allow — bit-exact with the
unfused apply, since both combine sums in ascending source partition.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import analysis
from . import view as view_mod
from .graph import Graph
from .mrtriplets import (_derive_need, _plan_apply, apply_plan_of,
                         fused_apply_home, mr_triplets, plan_of)
from .tree import (ElemSpec, elem_spec, tree_changed, tree_map,
                   tree_unflatten, tree_where, vmap2)


@dataclasses.dataclass
class PregelResult:
    graph: Graph
    supersteps: int
    metrics: list[dict]     # per-superstep engine metrics (track_metrics)


def _superstep(g: Graph, *, vprog, send_msg, gather, default_msg, skip_stale,
               changed_fn, kernel_mode, use_cache, payload_bound, aplan):
    """One BSP superstep; `aplan` is the fused apply plan or None."""
    gin = g if use_cache else g.replace(view=None)
    msgs, exists, view, metrics = mr_triplets(
        gin, send_msg, gather, to="dst", skip_stale=skip_stale,
        kernel_mode=kernel_mode, payload_bound=payload_bound,
        return_routed=aplan is not None)
    if aplan is not None:
        # `msgs` is the raw routed aggregate buffer: the kernel combines it
        # (the span lets a trace count the home half's launches)
        with torch.profiler.record_function("apply_home"):
            new_vdata, changed = fused_apply_home(g, msgs, exists, "dst",
                                                  gather, aplan, kernel_mode)
        msg_elem = tree_unflatten(list(aplan.msg_specs), aplan.msg_treedef)
    else:
        msgs_or_default = tree_where(exists, msgs, tree_map(
            lambda d, m: torch.as_tensor(d).to(m.device, m.dtype).expand_as(m),
            default_msg, msgs))
        new_vdata = vmap2(vprog)(g.s.home_vid, g.vdata, msgs_or_default)
        new_vdata = tree_where(g.vmask, new_vdata, g.vdata)
        if changed_fn is None:
            changed = tree_changed(new_vdata, g.vdata)
        else:
            changed = vmap2(changed_fn)(g.vdata, new_vdata)
        changed = changed & g.vmask
        msg_elem = elem_spec(msgs_or_default)
    live = changed.sum()
    if use_cache:
        rewrites = analysis.analyze_rewrites(
            vprog, (ElemSpec((), g.s.home_vid.dtype), elem_spec(g.vdata),
                    msg_elem), 1)
        view = view_mod.view_after_rewrite(view, g.vdata, new_vdata, rewrites,
                                           changed)
    g2 = g.replace(vdata=new_vdata, active=changed,
                   view=view if use_cache else None)
    return g2, live, metrics


def _to_host(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        if hasattr(v, "to_host"):
            v = v.to_host()
        elif isinstance(v, torch.Tensor):
            v = v.item() if v.dim() == 0 else v.tolist()
        out[k] = v
    return out


def pregel(g: Graph, vprog: Callable, send_msg: Callable,
           gather: str = "sum", *, default_msg: Any,
           max_supersteps: int = 50, skip_stale: str | None = "out",
           incremental: bool = True, changed_fn: Callable | None = None,
           kernel_mode: str = "auto", track_metrics: bool = False,
           payload_bound: int | None = None,
           fuse_apply: Any = "auto") -> PregelResult:
    """Host-driven BSP loop.  fuse_apply: "auto" fuses the apply half when
    eligible; False / "unfused" pins the unfused apply.  The loop reads the
    live count back every superstep to decide whether to halt."""
    fuse = kernel_mode != "unfused" and fuse_apply not in (False, "unfused")
    aplan = (_plan_apply(g, vprog, send_msg, gather, changed_fn, default_msg,
                         payload_bound) if fuse else None)
    deps = analysis.analyze_message_fn(
        send_msg, elem_spec(g.vdata), elem_spec(g.edata), elem_spec(g.vdata))
    static_info = {
        "join_arity": deps.n_way,
        "need": _derive_need(deps, None) or "none",
        "wire": g.ex.codec.name if g.ex.codec is not None else "f32",
        "transport_policy": "dense",
        "plan": plan_of(g, send_msg, gather, kernel_mode=kernel_mode,
                        payload_bound=payload_bound),
        "apply_plan": (apply_plan_of(
            g, vprog, send_msg, gather, changed_fn=changed_fn,
            default_msg=default_msg, kernel_mode=kernel_mode,
            payload_bound=payload_bound) if fuse else "unfused")}

    all_metrics: list[dict] = []
    steps = 0
    for _ in range(max_supersteps):
        g, live, metrics = _superstep(
            g, vprog=vprog, send_msg=send_msg, gather=gather,
            default_msg=default_msg, skip_stale=skip_stale,
            changed_fn=changed_fn, kernel_mode=kernel_mode,
            use_cache=incremental, payload_bound=payload_bound, aplan=aplan)
        steps += 1
        if track_metrics:
            host = _to_host(metrics)
            host.update(static_info)
            host["live"] = int(live)
            all_metrics.append(host)
        if int(live) == 0:
            break
    return PregelResult(graph=g, supersteps=steps, metrics=all_metrics)
