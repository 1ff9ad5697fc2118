"""The property graph — GraphX's unified data model (paper §3.1) in PyTorch.

A `Graph` holds the device-resident structural index (`Structure`, shared
across property updates: §4.3 index reuse is object sharing), vertex and
edge property pytrees ([P, V_blk, ...] and [P, E_blk, ...] tensors), the
visibility masks and the graph-resident replicated view.

Everything lives on one device, the card unless the caller asks otherwise:
`device=None` means "cuda", and without a CUDA device that raises rather
than running on the CPU.  The tests pass device="cpu", where the kernels'
plain versions run.

Operators (Listing 4 of the paper):
  vertices / edges / triplets   collection views (triplets reads through
                                the graph-resident view, visibility too)
  mapV / mapE                   property transforms, structure reused
  subgraph                      a visibility-restricted view that shares
                                the structure
  reverse                       the transpose: slots, routes and the
                                per-side GPU tables swap
  mrTriplets / degrees          see core.mrtriplets

UDF conventions (per element; the engine vmaps):
  mapV:                f(vid, vval) -> vval'
  mapE / epred / send: f(src_vval, eval, dst_vval) -> ...
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from . import analysis
from . import partition as part_mod
from . import view as view_mod
from .collections import Col
from .exchange import Exchange, LocalExchange
from .mrtriplets import edge_mask, endpoint_rows, mr_triplets
from .tree import (ElemSpec, elem_spec, gather_rows, tree_leaves, tree_map,
                   vmap2)
from .view import GraphView

_CANON = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
          np.dtype(np.uint64): np.uint32}


def resolve_device(device) -> torch.device:
    """The engine's device: the card unless the caller names another.  No
    CUDA device and no explicit device is an error, not a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor, with 64-bit types narrowed as the JAX reference
    (x64 off) stores them."""
    a = np.asarray(a)
    if a.dtype in _CANON:
        a = a.astype(_CANON[a.dtype])
    return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class Structure:
    """Device-resident structural index (immutable, shared)."""

    src_slot: torch.Tensor
    dst_slot: torch.Tensor
    src_perm: torch.Tensor
    edge_mask: torch.Tensor
    mirror_vid: torch.Tensor
    home_vid: torch.Tensor
    home_mask: torch.Tensor
    routes: dict              # need -> (send_idx, recv_slot)
    agg_ptr: dict             # side -> [P, V_mir+1] CSR row pointers
    agg_pieces: dict          # side -> segorder.Pieces of agg_ptr[side]
    agg_perm: dict            # side -> [P, E_blk] edge order of agg_ptr[side]
    #                           (None: the stored order)
    apply_rng: dict           # side -> [P, P, NB+1] route ranges
    p: int
    e_blk: int
    v_mir: int
    v_blk: int
    num_vertices: int
    num_edges: int
    max_vid: int
    has_bcast: bool = False

    @staticmethod
    def from_host(f: Mapping, device) -> "Structure":
        """From GraphStructure fields (a mapping of numpy arrays and ints);
        the GPU tables are built here when the mapping lacks them."""
        if f.get("agg_ptr") is None or f.get("agg_pieces") is None:
            agg_ptr, agg_pieces, apply_rng = part_mod.gpu_tables(
                f["src_slot"], f["dst_slot"], f["src_perm"], f["edge_mask"],
                f["routes"], int(f["v_mir"]), int(f["v_blk"]))
        else:
            agg_ptr, agg_pieces, apply_rng = (f["agg_ptr"], f["agg_pieces"],
                                              f["apply_rng"])
        moved: dict = {}

        def t(a):
            """One device tensor per host array (agg_perm shares src_perm)."""
            if id(a) not in moved:
                moved[id(a)] = _to_device(a, device)
            return moved[id(a)]

        agg_perm = f.get("agg_perm") or {"dst": None, "src": f["src_perm"]}
        return Structure(
            src_slot=t(f["src_slot"]), dst_slot=t(f["dst_slot"]),
            src_perm=t(f["src_perm"]), edge_mask=t(f["edge_mask"]),
            mirror_vid=t(f["mirror_vid"]), home_vid=t(f["home_vid"]),
            home_mask=t(f["home_mask"]),
            routes={k: (t(v[0]), t(v[1])) for k, v in f["routes"].items()},
            agg_ptr={k: t(v) for k, v in agg_ptr.items()},
            agg_pieces={k: type(v)(*map(t, v)) for k, v in agg_pieces.items()},
            agg_perm={k: None if v is None else t(v)
                      for k, v in agg_perm.items()},
            apply_rng={k: t(v) for k, v in apply_rng.items()},
            p=int(f["num_partitions"]), e_blk=int(f["e_blk"]),
            v_mir=int(f["v_mir"]), v_blk=int(f["v_blk"]),
            num_vertices=int(f["num_vertices"]),
            num_edges=int(f["num_edges"]), max_vid=int(f["max_vid"]),
            has_bcast=f.get("brecv") is not None)


def _degree_msg(sv, ev, dv):
    """Module-level UDF: plan and kernel caches key on the UDF object."""
    return {"deg": torch.tensor(1.0)}


# reverse(): the per-side tables swap aggregation roles; keys that name no
# side (the routes' "both") stay
_SIDE_SWAP = {"dst": "src", "src": "dst"}


def _swap_sides(d):
    return None if d is None else {_SIDE_SWAP.get(k, k): v
                                   for k, v in d.items()}


def _reversed_host(host: part_mod.GraphStructure) -> part_mod.GraphStructure:
    """The transposed host structure, memoised both ways: reverse() hands
    back the same object every time, and reverse().reverse() the
    original."""
    cached = getattr(host, "_reversed", None)
    if cached is None:
        agg_perm = host.agg_perm or {"dst": None, "src": host.src_perm}
        cached = dataclasses.replace(
            host, src_slot=host.dst_slot, dst_slot=host.src_slot,
            src_perm=np.tile(np.arange(host.e_blk, dtype=np.int32),
                             (host.num_partitions, 1)),
            routes=_swap_sides(host.routes), brecv=_swap_sides(host.brecv),
            p2p_routes=_swap_sides(host.p2p_routes),
            agg_ptr=_swap_sides(host.agg_ptr),
            agg_pieces=_swap_sides(host.agg_pieces),
            agg_perm=_swap_sides(agg_perm),
            apply_rng=_swap_sides(host.apply_rng))
        cached._reversed = host
        host._reversed = cached
    return cached


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    """Immutable distributed property graph G(P) = (V, E, P)."""

    s: Structure
    vdata: Any               # pytree [P, V_blk, ...]
    edata: Any               # pytree [P, E_blk, ...]
    vmask: torch.Tensor      # [P, V_blk] visibility
    emask: torch.Tensor      # [P, E_blk]
    active: torch.Tensor     # [P, V_blk] changed since the last ship
    view: GraphView = None   # graph-resident replicated view (None = cold)
    ex: Exchange = None
    host: part_mod.GraphStructure = None
    vmask_full: bool = False

    def replace(self, **kw) -> "Graph":
        """dataclasses.replace; rewriting vdata/vmask without saying what
        happened to the view drops it."""
        if ("vdata" in kw or "vmask" in kw) and "view" not in kw:
            kw["view"] = None
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.s.home_vid.device

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, *,
                   edge_values: Any = None,
                   vertex_keys: np.ndarray | None = None,
                   vertex_values: Any = None, default_vertex: Any = 0.0,
                   merge_v: str = "last", num_partitions: int = 4,
                   partitioner: str = "2d",
                   hybrid_threshold: int | None = None,
                   bcast_min_repl: int | None = None,
                   device=None) -> "Graph":
        """Build a property graph from edge and optional vertex collections
        (Listing 4's `Graph` operator).  Property pytrees are numpy."""
        dev = resolve_device(device)
        host = part_mod.build_structure(
            src, dst, num_partitions, vertex_ids=vertex_keys,
            partitioner=partitioner, hybrid_threshold=hybrid_threshold,
            bcast_min_repl=bcast_min_repl)
        p, v_blk, e_blk = host.num_partitions, host.v_blk, host.e_blk
        if edge_values is None:
            edge_values = {"w": np.ones(len(src), np.float32)}

        def place_edge(leaf):
            leaf = np.asarray(leaf)
            buf = np.zeros((p, e_blk) + leaf.shape[1:], leaf.dtype)
            buf[host.edge_part, host.edge_row] = leaf
            return buf

        if vertex_keys is None:
            vertex_keys = np.empty((0,), np.int64)
            vertex_values = tree_map(
                lambda d: np.empty((0,) + np.shape(d), np.asarray(d).dtype),
                default_vertex)
        vk = np.asarray(vertex_keys, np.int64)
        vpart, vrow = host.local_row(vk)

        def place_vertex(leaf, dflt):
            leaf = np.asarray(leaf)
            d = np.asarray(dflt)
            trailing = leaf.shape[1:] if leaf.size else d.shape
            buf = np.empty((p, v_blk) + trailing,
                           leaf.dtype if leaf.size else d.dtype)
            buf[...] = d
            if merge_v == "last" or vk.size == 0:
                buf[vpart, vrow] = leaf
            elif merge_v in ("sum", "min", "max"):
                {"sum": np.add, "min": np.minimum,
                 "max": np.maximum}[merge_v].at(buf, (vpart, vrow), leaf)
            else:
                raise ValueError(f"merge_v={merge_v}")
            return buf

        vdata = tree_map(place_vertex, vertex_values, default_vertex)
        fields = {f.name: getattr(host, f.name)
                  for f in dataclasses.fields(host)}
        return Graph.from_arrays(fields, vdata, tree_map(place_edge,
                                                         edge_values),
                                 device=dev, host=host)

    @staticmethod
    def from_arrays(structure: Mapping, vdata: Any, edata: Any, *, device,
                    host: part_mod.GraphStructure | None = None) -> "Graph":
        """A graph from GraphStructure fields (numpy, as a mapping) and
        [P, rows, ...] numpy property pytrees — e.g. a reference graph taken
        mid-run, continued here.  The view starts cold."""
        dev = resolve_device(device)
        s = Structure.from_host(structure, dev)
        return Graph(
            s=s, vdata=tree_map(lambda a: _to_device(a, dev), vdata),
            edata=tree_map(lambda a: _to_device(a, dev), edata),
            vmask=s.home_mask, emask=s.edge_mask, active=s.home_mask,
            ex=LocalExchange(s.p), host=host, vmask_full=True)

    # ------------------------------------------------------ collection views
    @property
    def vertex_ids(self) -> torch.Tensor:
        return self.s.home_vid

    def vertices(self) -> Col:
        """Collection view of the visible vertices (§3.2)."""
        return Col(self.s.home_vid, self.vdata, self.vmask, self.ex)

    def edges(self):
        """(src_vid, dst_vid, edata, mask) in slab order."""
        return (gather_rows(self.s.mirror_vid, self.s.src_slot),
                gather_rows(self.s.mirror_vid, self.s.dst_slot),
                self.edata, self.emask)

    def triplets(self):
        """The three-way join (§3.2): per edge (src_vid, dst_vid, src_vals,
        edata, dst_vals, mask), read through the graph-resident view; the
        mask also requires both endpoints visible."""
        view, mirror, _, _ = view_mod.refresh_view(
            self, "both", with_vis=not self.vmask_full)
        svid, dvid, edata, mask = self.edges()
        svals, dvals = endpoint_rows(self.s, mirror, self.vdata,
                                     tuple(mask.shape), True, True)
        mask = edge_mask(self.s, mask,
                         vis=None if self.vmask_full else view.vis)
        return svid, dvid, svals, edata, dvals, mask

    # ----------------------------------------------------------- transforms
    def mapV(self, f: Callable, *, changed=None) -> "Graph":
        """f(vid, vval) -> vval'; structure reused.  Leaves f provably
        passes through stay clean in the view; the rest go dirty."""
        new_vdata = vmap2(f)(self.s.home_vid, self.vdata)
        rewrites = analysis.analyze_rewrites(
            f, (ElemSpec((), self.s.home_vid.dtype), elem_spec(self.vdata)), 1)
        view = view_mod.view_after_rewrite(
            self.view, self.vdata, new_vdata, rewrites, changed)
        return self.replace(vdata=new_vdata, view=view)

    def mapE(self, f: Callable) -> "Graph":
        """f(src_vval, eval, dst_vval) -> eval'; only the vertex leaves f
        reads ship, through the graph-resident view."""
        vex, eex = elem_spec(self.vdata), elem_spec(self.edata)
        deps = analysis.analyze_message_fn(f, vex, eex, vex)
        need = ("both" if deps.uses_src and deps.uses_dst
                else "src" if deps.uses_src
                else "dst" if deps.uses_dst else None)
        view, mirror = self.view, None
        if need is not None:
            view, mirror, _, _ = view_mod.refresh_view(
                self, need, leaf_mask=deps.read_leaf_mask(
                    len(tree_leaves(self.vdata))))
        svals, dvals = endpoint_rows(self.s, mirror, self.vdata,
                                     tuple(self.emask.shape),
                                     need in ("src", "both"),
                                     need in ("dst", "both"))
        return self.replace(view=view,
                            edata=vmap2(f)(svals, self.edata, dvals))

    # ------------------------------------------------------------- restrict
    def subgraph(self, vpred: Callable | None = None,
                 epred: Callable | None = None) -> "Graph":
        """Visibility-restricted view (§4.3): no rebuild, the structure is
        shared; kept edges satisfy epred and both endpoints' vpred.  Only
        the visibility rows whose bit flipped go dirty; the visibility ship
        and the property leaves epred reads share one refresh."""
        vmask, view = self.vmask, self.view
        if vpred is not None:
            vmask = vmask & vmap2(vpred)(self.s.home_vid, self.vdata)
            if view is not None:
                view = view.mark_vis(self.vmask ^ vmask)
        g = self.replace(vmask=vmask, view=view, active=self.active & vmask,
                         vmask_full=self.vmask_full and vpred is None)
        nleaves = len(tree_leaves(self.vdata))
        if epred is not None:
            vex, eex = elem_spec(self.vdata), elem_spec(self.edata)
            leaf_mask = analysis.analyze_message_fn(
                epred, vex, eex, vex).read_leaf_mask(nleaves)
        else:
            leaf_mask = (False,) * nleaves
        with_vis = not g.vmask_full
        if epred is None and not with_vis:
            return g
        view, mirror, _, _ = view_mod.refresh_view(
            g, "both", leaf_mask=leaf_mask, with_vis=with_vis)
        emask = edge_mask(g.s, g.emask, vis=view.vis if with_vis else None,
                          epred=epred, mirror=mirror, vdata=self.vdata,
                          edata=self.edata)
        return g.replace(view=view, emask=emask)

    def reverse(self) -> "Graph":
        """The transpose: src and dst slots swap, and so do the routes and
        the per-side GPU tables (agg_ptr, agg_pieces, agg_perm, apply_rng),
        so the new "dst" side walks the old src order.  src_perm becomes
        the identity, as in the reference; the host structure is memoised
        both ways and the view is remapped, not dropped."""
        s = self.s
        ident = torch.arange(s.e_blk, dtype=torch.int32,
                             device=s.src_perm.device).expand(s.p, s.e_blk)
        s2 = dataclasses.replace(
            s, src_slot=s.dst_slot, dst_slot=s.src_slot, src_perm=ident,
            routes=_swap_sides(s.routes), agg_ptr=_swap_sides(s.agg_ptr),
            agg_pieces=_swap_sides(s.agg_pieces),
            agg_perm=_swap_sides(s.agg_perm),
            apply_rng=_swap_sides(s.apply_rng))
        host = None if self.host is None else _reversed_host(self.host)
        view = None if self.view is None else self.view.remap_reverse()
        return self.replace(s=s2, host=host, view=view)

    # ------------------------------------------------------------ mrTriplets
    def mrTriplets(self, map_fn: Callable, reduce: str = "sum", *,
                   to: str = "dst", skip_stale: str | None = None,
                   kernel_mode: str = "auto", force_need: str | None = None,
                   payload_bound: int | None = None, transport=None,
                   epred: Callable | None = None):
        """See `core.mrtriplets.mr_triplets`.  Returns (values, exists,
        graph', metrics), graph' carrying the refreshed view and, under a
        pushed-down `epred`, the restricted edge mask."""
        values, exists, view, metrics = mr_triplets(
            self, map_fn, reduce, to=to, skip_stale=skip_stale,
            kernel_mode=kernel_mode, force_need=force_need,
            payload_bound=payload_bound, transport=transport, epred=epred)
        g = self.replace(view=view)
        if "emask_pushed" in metrics:
            g = g.replace(emask=metrics["emask_pushed"])
        return values, exists, g, metrics

    def degrees(self, direction: str = "in", kernel_mode: str = "auto"):
        """Vertex degrees via a join-eliminated mrTriplets (§4.5.2)."""
        to = "dst" if direction == "in" else "src"
        vals, exists, _, metrics = self.mrTriplets(
            _degree_msg, "sum", to=to, kernel_mode=kernel_mode)
        return torch.where(exists, vals["deg"], 0.0), metrics

    # ----------------------------------------------------------------- host
    def vertices_to_numpy(self):
        mask = self.vmask.cpu().numpy()
        vals = tree_map(lambda v: v.cpu().numpy()[mask], self.vdata)
        return self.s.home_vid.cpu().numpy()[mask], vals

    def edges_to_numpy(self):
        """(src_vid, dst_vid, edata) of the live edges, in slab order."""
        svid, dvid, edata, mask = self.edges()
        m = mask.cpu().numpy()
        return (svid.cpu().numpy()[m], dvid.cpu().numpy()[m],
                tree_map(lambda e: e.cpu().numpy()[m], edata))
