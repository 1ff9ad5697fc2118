"""Graph-resident incremental view maintenance (paper §4.5.1).

The replicated vertex view is a member of `Graph`: a `GraphView` holds the
materialised mirror pytree and, per vdata leaf, a per-direction dirty mask
over home rows ([nl, 2, V_blk]: row 0 "s", row 1 "d"), with static records
of which route directions each leaf has been shipped over (`dirs`) and
which may be dirty (`stale`).  Mutators mark dirtiness instead of dropping
the view (`view_after_rewrite`); `refresh_view` is the one read path, where
each requested leaf resolves to a cache hit (no ship), a delta ship of its
dirty rows, or a full ship of its missing directions, and leaves with the
same resolution share one routed collective.

Caching changes ships, never values: a clean mirror slot already holds what
a cold ship would rematerialise.  Under a `resident=True` wire codec the
eligible mirror leaves are `wire.ResidentLeaf`s, encoded in device memory
(§2.4); the unfused plan decodes the mirror on read and the fused triplet
plan reads the encoded one (the host pays the decode only where a consumer
reads values).

The visibility mask has a mirror of its own (`vis`, with `vis_dirty`,
`vis_dirs` and `vis_stale` kept as for a leaf): `subgraph` marks only the
rows whose bit flipped, `refresh_view(..., with_vis=True)` ships it in the
same routed collective as the property leaves that resolve alike (the
subgraph visibility + `epred` property ship folds into one), and
`reverse()` remaps the direction labels instead of dropping the view.

`WireLog` is the pipeline-level account of the ships a graph's lineage has
run (the reference's `view.WireLog`): `Graph` carries it, its operators
that refresh the view add their ships, and every Pregel superstep adds its
own, with the bytes its transport really moved (a ragged ship's compacted
payload, indices and counts; the broadcast lane's all-gather).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import wire as wire_mod
from .mrtriplets import ShipMetrics, ViewCache, ship_to_mirrors
from .tree import (tree_flatten, tree_flatten_with_path, tree_leaves,
                   tree_map, tree_unflatten, vmap2)

_DIR = {"src": "s", "dst": "d", "both": "sd"}
_NEED = {"s": "src", "d": "dst", "sd": "both"}
# the rows of each direction string in a [nl, 2, V_blk] dirty mask, as a
# slice: indexing with a Python list would copy an index tensor to the
# device on every call, which a captured superstep cannot do
_DIRROWS = {"s": slice(0, 1), "d": slice(1, 2), "sd": slice(0, 2)}


def _dirs_union(a: str, b: str) -> str:
    return "".join(c for c in "sd" if c in a or c in b)


def _dirs_minus(a: str, b: str) -> str:
    return "".join(c for c in a if c not in b)


def _dir_rows(mask: torch.Tensor, dirs: str) -> torch.Tensor:
    """[nl, 2, V_blk] mask -> [nl, V_blk] union over the named directions."""
    return mask[:, _DIRROWS[dirs]].any(dim=1)


@dataclasses.dataclass(frozen=True)
class WireLog:
    """Pipeline-level wire-traffic accumulators, carried by `Graph`: the
    routed collectives an operator chain ran and the bytes they moved.

    Shaped [nl] f32 like the reference's (which shards them with the
    graph): a count lands in row 0 and a total is the sum.  `add` makes
    no host sync and no host-to-device copy, so a captured superstep can
    bump the log."""

    ships: torch.Tensor            # [nl] f32: routed collectives run
    bytes_shipped: torch.Tensor    # [nl] f32: what the transports moved
    bytes_accounted: torch.Tensor  # [nl] f32: the codec accounting

    @staticmethod
    def zeros(nl: int, device=None) -> "WireLog":
        z = lambda: torch.zeros((nl,), dtype=torch.float32, device=device)  # noqa: E731
        return WireLog(z(), z(), z())

    def add(self, n_ships, shipped, accounted) -> "WireLog":
        """Row 0 of each accumulator plus a Python number or a 0-d tensor
        on the log's device, cast to f32 as the reference casts it."""
        def bump(a, x):
            out = a.clone()
            out[0] += x.to(a.dtype) if isinstance(x, torch.Tensor) else x
            return out
        return WireLog(bump(self.ships, n_ships),
                       bump(self.bytes_shipped, shipped),
                       bump(self.bytes_accounted, accounted))


@dataclasses.dataclass(frozen=True)
class GraphView:
    """Graph-resident replicated vertex view with per-leaf dirty tracking."""

    mirror: Any               # pytree == vdata, leaves [nl, V_mir, ...]
    #                           (tensors or wire.ResidentLeaf)
    vis: torch.Tensor         # [nl, V_mir] bool — visibility mirror
    filled: torch.Tensor      # [nl, V_mir] bool — slot ever shipped
    active: torch.Tensor      # [nl, V_mir] bool — slots of the latest refresh
    dirty: Any                # pytree == vdata, leaves [nl, 2, V_blk] bool
    vis_dirty: torch.Tensor   # [nl, 2, V_blk] bool
    dirs: tuple = ()          # per flat leaf: filled directions
    vis_dirs: str = ""
    stale: tuple = ()         # per flat leaf: maybe-dirty directions
    vis_stale: str = ""

    def replace(self, **kw) -> "GraphView":
        return dataclasses.replace(self, **kw)

    def mark_vis(self, rows: torch.Tensor) -> "GraphView":
        """Visibility changed at `rows` [nl, V_blk] (a subgraph
        restriction): those rows go dirty in both directions."""
        return self.replace(vis_dirty=self.vis_dirty | rows[:, None],
                            vis_stale=self.vis_dirs)

    def remap_reverse(self) -> "GraphView":
        """`reverse()` swaps the src/dst roles of the routing tables; the
        mirror values stay, so the direction labels and the per-direction
        dirty rows swap with them."""
        swap = {"": "", "s": "d", "d": "s", "sd": "sd"}
        flip = lambda m: m.flip(1)      # noqa: E731
        return self.replace(dirs=tuple(swap[d] for d in self.dirs),
                            vis_dirs=swap[self.vis_dirs],
                            stale=tuple(swap[st] for st in self.stale),
                            vis_stale=swap[self.vis_stale],
                            dirty=tree_map(flip, self.dirty),
                            vis_dirty=flip(self.vis_dirty))


def empty_view(s, vdata, nl: int, codec=None,
               bound: int | None = None) -> GraphView:
    """A cold view: nothing filled, nothing dirty.  Under a resident codec
    the eligible mirror leaves start encoded, so the view's structure is
    the same cold and warm."""
    dev = s.home_mask.device
    v_blk = s.home_mask.shape[-1]

    def cold_leaf(x):
        z = x.new_zeros((nl, s.v_mir) + tuple(x.shape[2:]))
        kind = wire_mod.resident_kind(x.dtype, codec, bound)
        return (wire_mod.encode_resident(z, codec, kind, bound=bound)
                if kind is not None else z)

    mirror = tree_map(cold_leaf, vdata)
    dirty = tree_map(lambda x: torch.zeros((nl, 2, v_blk), dtype=torch.bool,
                                           device=dev), vdata)
    n = len(tree_leaves(vdata))
    zslot = torch.zeros((nl, s.v_mir), dtype=torch.bool, device=dev)
    return GraphView(mirror=mirror, vis=zslot, filled=zslot, active=zslot,
                     dirty=dirty,
                     vis_dirty=torch.zeros((nl, 2, v_blk), dtype=torch.bool,
                                           device=dev),
                     dirs=("",) * n, stale=("",) * n)


def compatible(view: GraphView | None, vdata, nl: int, v_mir: int) -> bool:
    """Does this view's mirror match vdata's structure and element specs?
    Resident leaves compare through their decoded dtype and shape."""
    if view is None:
        return False
    m_leaves, m_spec = tree_flatten(view.mirror)
    v_leaves, v_spec = tree_flatten(vdata)
    if m_spec != v_spec:
        return False
    return all(m.dtype == v.dtype and m.shape[2:] == v.shape[2:]
               and tuple(m.shape[:2]) == (nl, v_mir)
               for m, v in zip(m_leaves, v_leaves))


def _plan_leaf(dirs: str, stale: str, need_d: str):
    """One leaf's refresh: [(kind, route_dirs)], empty = cache hit.  Stale
    rows of needed, filled directions delta-ship; missing directions
    full-ship."""
    plans = []
    dirty_hit = "".join(c for c in need_d if c in dirs and c in stale)
    if dirty_hit:
        plans.append(("delta", dirty_hit))
    missing = _dirs_minus(need_d, dirs)
    if missing:
        plans.append(("full", missing))
    return plans


def refresh_view(g, need: str, *, leaf_mask=None, with_vis: bool = False,
                 bound: int | None = None, transport=None,
                 prefer_ragged: torch.Tensor | None = None,
                 legacy_cache: GraphView | None = None):
    """Materialise the replicated view for one consumer through the cache.

    Returns (view', mirror_tree, merged ShipMetrics, n_ships): mirror_tree
    is the view's mirror as it holds it (resident leaves encoded: a
    consumer that reads values decodes it, `wire.decode_tree`), n_ships
    the number of routed collectives this refresh ran (0 for a clean
    view); leaves the consumer does not read keep whatever the view holds.
    with_vis: also bring the visibility mirror `view'.vis` up to date over
    both directions, in the same collective as the leaves that resolve
    alike.  bound: |value| bound of lossless int narrowing on the wire.
    transport / prefer_ragged: the plan of the delta ships (a full ship
    has nothing to compact and stays dense).

    legacy_cache: the reference's legacy `mr_triplets(cache=...)`
    contract: this view, with `g.active` as the changed rows of every
    requested leaf in place of the view's own dirty state, and every
    filled direction kept coherent."""
    s, ex = g.s, g.ex
    nl = g.vmask.shape[0]
    flat_vals, treedef = tree_flatten(g.vdata)
    n = len(flat_vals)
    view = legacy_cache if legacy_cache is not None else g.view
    if not compatible(view, g.vdata, nl, s.v_mir):
        view = empty_view(s, g.vdata, nl, ex.codec, bound)
    mir_l = list(tree_leaves(view.mirror))
    dirty_l = list(tree_leaves(view.dirty))
    dirs_l, stale_l = list(view.dirs), list(view.stale)
    vis_mir, vis_dirty = view.vis, view.vis_dirty
    vis_dirs, vis_stale = view.vis_dirs, view.vis_stale
    if legacy_cache is not None:
        rows = g.active
        dirty_l = [rows[:, None].expand((nl, 2) + tuple(rows.shape[1:]))] * n
        stale_l = ["sd"] * n
    required = tuple(leaf_mask) if leaf_mask is not None else (True,) * n
    need_d = _DIR[need]

    def leaf_need(i: int) -> str:
        # a legacy loop's g.active is only the last step's change set, so
        # every filled direction ships each refresh
        if legacy_cache is not None:
            return _dirs_union(need_d, dirs_l[i])
        return need_d

    entries = [(i, kind, route_d) for i in range(n) if required[i]
               for kind, route_d in _plan_leaf(dirs_l[i], stale_l[i],
                                               leaf_need(i))]
    if with_vis:
        entries += [("vis", kind, route_d) for kind, route_d in
                    _plan_leaf(vis_dirs, vis_stale, "sd")]
    groups: dict = {}
    for e in entries:
        groups.setdefault((e[1], e[2]), []).append(e[0])

    def key(slot):
        return "vis" if slot == "vis" else f"l{slot}"

    filled = view.filled
    shipped_any = torch.zeros((nl, s.v_mir), dtype=torch.bool,
                              device=filled.device)
    merged, n_ships = None, 0
    for (kind, route_d), slots in groups.items():
        vals = {key(i): g.vmask if i == "vis" else flat_vals[i] for i in slots}
        prev = {key(i): vis_mir if i == "vis" else mir_l[i] for i in slots}
        act = None
        if kind == "delta":
            for i in slots:
                d = _dir_rows(vis_dirty if i == "vis" else dirty_l[i], route_d)
                act = d if act is None else (act | d)
        sub, m = ship_to_mirrors(
            s, vals, _NEED[route_d], ex, active=act,
            cache=ViewCache(mirror=prev, filled=filled, active=filled),
            bound=bound,
            transport=transport if kind == "delta" else None,
            prefer_ragged=prefer_ragged if kind == "delta" else None)
        n_ships += 1
        merged = m if merged is None else merged.merge(m)
        filled = sub.filled
        shipped_any = shipped_any | sub.active
        for i in slots:
            if i == "vis":
                vis_mir = sub.mirror["vis"]
            else:
                mir_l[i] = sub.mirror[key(i)]

    if not entries:
        # nothing to track: no delta information, every slot counts fresh
        shipped_any = torch.ones_like(shipped_any)

    def clear_rows(mask, dirs):
        mask = mask.clone()
        mask[:, _DIRROWS[dirs]] = False
        return mask

    shipped_dirs: dict = {}
    for i, _kind, route_d in entries:
        shipped_dirs[i] = _dirs_union(shipped_dirs.get(i, ""), route_d)
    for i in range(n):
        if not required[i]:
            continue
        sd = shipped_dirs.get(i, "")
        if sd:
            dirty_l[i] = clear_rows(dirty_l[i], sd)
        stale_l[i] = _dirs_minus(stale_l[i], sd)
        dirs_l[i] = _dirs_union(dirs_l[i], leaf_need(i))
    if with_vis:
        sd = shipped_dirs.get("vis", "")
        if sd:
            vis_dirty = clear_rows(vis_dirty, sd)
        vis_stale = _dirs_minus(vis_stale, sd)
        vis_dirs = "sd"

    view2 = GraphView(
        mirror=tree_unflatten(mir_l, treedef), vis=vis_mir, filled=filled,
        active=shipped_any, dirty=tree_unflatten(dirty_l, treedef),
        vis_dirty=vis_dirty, dirs=tuple(dirs_l), vis_dirs=vis_dirs,
        stale=tuple(stale_l), vis_stale=vis_stale)
    return (view2, view2.mirror,
            merged if merged is not None else ShipMetrics.zero(filled.device),
            n_ships)


def dirty_rows(view: GraphView | None, leaf_mask=None):
    """Union of the requested leaves' may-be-dirty rows over their stale
    directions, or None when every requested leaf is statically clean."""
    if view is None:
        return None
    flat = tree_leaves(view.dirty)
    required = tuple(leaf_mask) if leaf_mask is not None else (True,) * len(flat)
    out = None
    for d, req, st in zip(flat, required, view.stale):
        if req and st:
            rows = _dir_rows(d, st)
            out = rows if out is None else (out | rows)
    return out


def keep_through(old_vdata, exclude: tuple = ()) -> dict:
    """A `rewrites` map marking every old leaf passthrough, except the keys
    (or key-path prefixes) in `exclude` — for updates that only add or
    overwrite named leaves."""
    prefixes = [e if isinstance(e, tuple) else (e,) for e in exclude]

    def kept(path):
        ks = tuple(getattr(e, "key", None) for e in path)
        return not any(ks[:len(pfx)] == pfx for pfx in prefixes)

    return {p: kept(p) for p, _ in tree_flatten_with_path(old_vdata)[0]}


def prune_view(view: GraphView | None,
               keep_dirs: tuple[str, ...] | None) -> GraphView | None:
    """Forget per-leaf view state no remaining consumer reads: the chain
    planner's join-elimination primitive (`core/planner.py`).  keep_dirs is
    a per-flat-leaf direction set ("", "s", "d", "sd"); each leaf's filled
    directions shrink to the intersection, and the dropped directions
    forget their dirty rows (they will never delta-ship; a later read takes
    the cold full-ship path: more bytes, the same values).  The visibility
    state is never pruned.  None keep_dirs, a None view or a length
    mismatch is a no-op, and so is a keep set that changes nothing: the
    same object comes back, which the planner tests for."""
    if view is None or keep_dirs is None:
        return view
    flat_dirty, ddef = tree_flatten(view.dirty)
    if len(keep_dirs) != len(flat_dirty):
        return view
    dirs, stale, dirty = [], [], []
    for d0, st0, dy0, keep in zip(view.dirs, view.stale, flat_dirty,
                                  keep_dirs):
        d = "".join(c for c in d0 if c in keep)
        if d != d0:
            dy0 = dy0.clone()
            dy0[:, _DIRROWS[_dirs_minus("sd", d)]] = False
            st0 = "".join(c for c in st0 if c in d)
        dirs.append(d)
        stale.append(st0)
        dirty.append(dy0)
    if tuple(dirs) == tuple(view.dirs):
        return view
    return view.replace(dirty=tree_unflatten(dirty, ddef), dirs=tuple(dirs),
                        stale=tuple(stale))


def view_after_rewrite(view: GraphView | None, old_vdata, new_vdata,
                       rewrites: dict | None, changed=None) -> GraphView | None:
    """Carry a GraphView across a vertex-property rewrite.

    rewrites: {output leaf path: passthrough?} (analysis.analyze_rewrites),
    None to dirty every surviving leaf.  changed: the rows the rewrite
    touched — None (all), "diff", a callable f(old_elem, new_elem) -> bool,
    or a [nl, V_blk] bool tensor.  Leaves match by path: passthrough leaves
    keep their state, rewritten ones gain dirty rows (both keep resident
    mirrors encoded), new or retyped ones start cold."""
    if view is None:
        return None
    old_paths = {p: i for i, (p, _) in enumerate(
        tree_flatten_with_path(old_vdata)[0])}
    new_flat, new_def = tree_flatten_with_path(new_vdata)
    old_mir = tree_leaves(view.mirror)
    old_dirty = tree_leaves(view.dirty)
    old_vals = tree_leaves(old_vdata)
    nl, v_mir = view.filled.shape
    v_blk = old_dirty[0].shape[-1] if old_dirty else 0
    dev = view.filled.device

    rows_all = None
    if isinstance(changed, torch.Tensor):
        rows_all = changed
    elif callable(changed):
        rows_all = vmap2(changed)(old_vdata, new_vdata)

    mir, dirty, dirs, stale = [], [], [], []
    for path, leaf in new_flat:
        i = old_paths.get(path)
        keeps = (i is not None and old_mir[i].dtype == leaf.dtype
                 and old_mir[i].shape[2:] == leaf.shape[2:])
        if not keeps:
            mir.append(leaf.new_zeros((nl, v_mir) + tuple(leaf.shape[2:])))
            dirty.append(torch.zeros((nl, 2, leaf.shape[1]), dtype=torch.bool,
                                     device=dev))
            dirs.append("")
            stale.append("")
            continue
        mir.append(old_mir[i])
        if rewrites is not None and rewrites.get(path, False):
            dirty.append(old_dirty[i])
            dirs.append(view.dirs[i])
            stale.append(view.stale[i])
            continue
        if rows_all is not None:
            rows = rows_all
        elif changed == "diff":
            d = leaf != old_vals[i]
            rows = d.reshape(d.shape[:2] + (-1,)).any(-1) if d.dim() > 2 else d
        else:
            rows = torch.ones((nl, v_blk), dtype=torch.bool, device=dev)
        dirty.append(old_dirty[i] | rows[:, None])
        dirs.append(view.dirs[i])
        stale.append(view.dirs[i])
    return view.replace(mirror=tree_unflatten(mir, new_def),
                        dirty=tree_unflatten(dirty, new_def),
                        dirs=tuple(dirs), stale=tuple(stale))
