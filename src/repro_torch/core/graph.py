"""The property graph — GraphX's unified data model (paper §3.1) in PyTorch.

A `Graph` holds the device-resident structural index (`Structure`, shared
across property updates: §4.3 index reuse is object sharing), vertex and
edge property pytrees ([P, V_blk, ...] and [P, E_blk, ...] tensors), the
visibility masks and the graph-resident replicated view.

Everything lives on one device, the card unless the caller asks otherwise:
`device=None` means "cuda", and without a CUDA device that raises rather
than running on the CPU.  The tests pass device="cpu", where the kernels'
plain versions run.

UDF conventions (per element; the engine vmaps):
  mapV:        f(vid, vval) -> vval'
  mrTriplets:  f(src_vval, eval, dst_vval) -> message pytree
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from . import analysis
from . import partition as part_mod
from . import view as view_mod
from .exchange import Exchange, LocalExchange
from .mrtriplets import mr_triplets
from .tree import ElemSpec, elem_spec, tree_map, vmap2
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
        t = lambda a: _to_device(a, device)      # noqa: E731
        return Structure(
            src_slot=t(f["src_slot"]), dst_slot=t(f["dst_slot"]),
            src_perm=t(f["src_perm"]), edge_mask=t(f["edge_mask"]),
            mirror_vid=t(f["mirror_vid"]), home_vid=t(f["home_vid"]),
            home_mask=t(f["home_mask"]),
            routes={k: (t(v[0]), t(v[1])) for k, v in f["routes"].items()},
            agg_ptr={k: t(v) for k, v in agg_ptr.items()},
            agg_pieces={k: type(v)(*map(t, v)) for k, v in agg_pieces.items()},
            apply_rng={k: t(v) for k, v in apply_rng.items()},
            p=int(f["num_partitions"]), e_blk=int(f["e_blk"]),
            v_mir=int(f["v_mir"]), v_blk=int(f["v_blk"]),
            num_vertices=int(f["num_vertices"]),
            num_edges=int(f["num_edges"]), max_vid=int(f["max_vid"]),
            has_bcast=f.get("brecv") is not None)


def _degree_msg(sv, ev, dv):
    """Module-level UDF: plan and kernel caches key on the UDF object."""
    return {"deg": torch.tensor(1.0)}


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

    def mrTriplets(self, map_fn: Callable, reduce: str = "sum", *,
                   to: str = "dst", skip_stale: str | None = None,
                   kernel_mode: str = "auto", force_need: str | None = None,
                   payload_bound: int | None = None, transport=None):
        """See `core.mrtriplets.mr_triplets`.  Returns (values, exists,
        graph', metrics), graph' carrying the refreshed view."""
        values, exists, view, metrics = mr_triplets(
            self, map_fn, reduce, to=to, skip_stale=skip_stale,
            kernel_mode=kernel_mode, force_need=force_need,
            payload_bound=payload_bound, transport=transport)
        return values, exists, self.replace(view=view), metrics

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
