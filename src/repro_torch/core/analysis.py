"""Automatic join elimination by dependency analysis (paper §4.5.2).

GraphX-on-Spark inspects the JVM bytecode of the mrTriplets map UDF to see
whether it reads the source and/or destination vertex attributes, then
rewrites the 3-way join down to 2-way or none.  The reference takes a
backward slice of the UDF's jaxpr; the port traces
`make_fx(torch.func.vmap(udf))` on one-scalar-per-edge example leaves and
takes the same slice over the resulting aten graph.  The same trace yields
the UDF's output element specs (fused-plan eligibility) and is what
`kernels/udf.py` lowers into CUDA C, so one trace serves analysis, planning
and code generation.

Traces are cached on (function object, argument specs): eager host loops
call mrTriplets every superstep with the same UDF objects.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .tree import ElemSpec, tree_flatten, tree_flatten_with_path, tree_unflatten

TRACE_BATCH = 2           # example batch: per-element UDFs see [B] tensors

# value-preserving aten ops: the output IS the input value (for the scalar-
# per-element leaves this slice traces)
NOOP_OPS = frozenset({
    torch.ops.aten.alias.default, torch.ops.aten.view.default,
    torch.ops.aten._unsafe_view.default, torch.ops.aten.reshape.default,
    torch.ops.aten.expand.default, torch.ops.aten.clone.default,
    torch.ops.aten.detach.default, torch.ops.aten.lift_fresh_copy.default,
})


@dataclasses.dataclass(frozen=True, eq=False)
class Traced:
    """One `make_fx(vmap(fn))` trace over flat example leaves."""

    gm: torch.fx.GraphModule
    placeholders: tuple       # fx placeholder nodes, in flat-input order
    arg_sizes: tuple[int, ...]    # flat leaf count of each argument
    out_spec: Any             # TreeSpec of the output
    out_leaves: tuple[ElemSpec, ...]
    needed: frozenset         # backward slice (fx nodes) from the outputs

    def out_nodes(self):
        (out,) = [n for n in self.gm.graph.nodes if n.op == "output"]
        return list(out.args[0])


def _freeze(tree) -> tuple:
    leaves, spec = tree_flatten(tree)
    return spec, tuple(leaves)


def _slice(out_nodes) -> frozenset:
    """Backward slice: every fx node that can reach an output."""
    needed, stack = set(), [n for n in out_nodes if isinstance(n, torch.fx.Node)]
    while stack:
        n = stack.pop()
        if n not in needed:
            needed.add(n)
            stack.extend(n.all_input_nodes)
    return frozenset(needed)


@functools.lru_cache(maxsize=512)
def _trace(fn: Callable, frozen: tuple) -> Traced | None:
    flat_specs = [l for _, leaves in frozen for l in leaves]
    # distinct tensors per leaf: make_fx keys placeholders by tensor identity
    example = [torch.ones((TRACE_BATCH,) + tuple(s.shape), dtype=s.dtype)
               for s in flat_specs]
    sizes = tuple(len(leaves) for _, leaves in frozen)
    holder = {}

    def flat_fn(*flat):
        args, off = [], 0
        for (spec, _), n in zip(frozen, sizes):
            args.append(tree_unflatten(list(flat[off:off + n]), spec))
            off += n
        out = torch.func.vmap(fn)(*args)
        leaves, ospec = tree_flatten(out)
        holder["spec"] = ospec
        holder["leaves"] = tuple(ElemSpec(tuple(t.shape[1:]), t.dtype)
                                 for t in leaves)
        return leaves

    try:
        gm = make_fx(flat_fn, tracing_mode="real")(*example)
    except Exception:            # untraceable UDF: callers stay conservative
        return None
    ph = tuple(n for n in gm.graph.nodes if n.op == "placeholder")
    (out,) = [n for n in gm.graph.nodes if n.op == "output"]
    return Traced(gm=gm, placeholders=ph, arg_sizes=sizes,
                  out_spec=holder["spec"], out_leaves=holder["leaves"],
                  needed=_slice(list(out.args[0])))


def trace_udf(fn: Callable, *arg_specs) -> Traced | None:
    """Trace `vmap(fn)` over pytrees of ElemSpecs (cached)."""
    return _trace(fn, tuple(_freeze(a) for a in arg_specs))


def resolve_noop(node):
    """Follow value-preserving ops back to the node that made the value."""
    while (isinstance(node, torch.fx.Node) and node.op == "call_function"
           and node.target in NOOP_OPS):
        node = node.args[0]
    return node


@dataclasses.dataclass(frozen=True)
class TripletDeps:
    """Which triplet fields the map UDF actually reads (per side and, where
    known, per flattened vertex leaf), plus the output element specs."""

    uses_src: bool
    uses_dst: bool
    uses_edge: bool
    src_leaves: tuple[bool, ...] | None = None
    dst_leaves: tuple[bool, ...] | None = None
    msg_spec: Any = None          # pytree of ElemSpec; None = trace failed

    @property
    def n_way(self) -> int:
        """Width of the physical join after elimination (paper Fig. 5)."""
        return 1 + int(self.uses_src) + int(self.uses_dst)

    def read_leaf_mask(self, nleaves: int) -> tuple[bool, ...] | None:
        """Per-flat-vdata-leaf 'read through either side', or None."""
        if (self.src_leaves is None or self.dst_leaves is None
                or len(self.src_leaves) != nleaves
                or len(self.dst_leaves) != nleaves):
            return None
        return tuple(su or du for su, du in
                     zip(self.src_leaves, self.dst_leaves))


def analyze_message_fn(fn: Callable, src_example: Any, edge_example: Any,
                       dst_example: Any) -> TripletDeps:
    """Trace `fn(src, edge, dst)` and report operand usage; an untraceable
    UDF reports full usage (elimination is an optimisation, never a
    semantics change)."""
    tr = trace_udf(fn, src_example, edge_example, dst_example)
    if tr is None:
        return TripletDeps(True, True, True)
    n_s, n_e, _ = tr.arg_sizes
    used = [p in tr.needed for p in tr.placeholders]
    src_u, edge_u, dst_u = used[:n_s], used[n_s:n_s + n_e], used[n_s + n_e:]
    return TripletDeps(
        uses_src=any(src_u), uses_dst=any(dst_u), uses_edge=any(edge_u),
        src_leaves=tuple(src_u), dst_leaves=tuple(dst_u),
        msg_spec=tree_unflatten(list(tr.out_leaves), tr.out_spec))


def analyze_rewrites(fn: Callable, args_example: tuple,
                     v_argnum: int) -> dict | None:
    """Which output leaves of a vertex-property rewrite pass the same-path
    leaf of argument `v_argnum` through untouched?  {output leaf path:
    bool}, or None when the trace fails (callers then dirty every leaf).
    Sound, never complete: a copy the tracer cannot see through reports a
    rewrite, which costs bytes, never correctness."""
    tr = trace_udf(fn, *args_example)
    if tr is None:
        return None
    off = sum(tr.arg_sizes[:v_argnum])
    v_paths = [p for p, _ in tree_flatten_with_path(
        args_example[v_argnum])[0]]
    v_node_of = {path: tr.placeholders[off + i]
                 for i, path in enumerate(v_paths)}
    out_tree = tree_unflatten(list(tr.out_leaves), tr.out_spec)
    out_paths = [p for p, _ in tree_flatten_with_path(out_tree)[0]]
    outs = tr.out_nodes()
    if len(out_paths) != len(outs):
        return None
    return {path: v_node_of.get(path) is resolve_noop(node)
            for path, node in zip(out_paths, outs)}
