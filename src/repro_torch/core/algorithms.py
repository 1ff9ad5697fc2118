"""Graph algorithms composed from the narrow-waist operators (§3.3):
PageRank, connected components, SSSP, label propagation, triangle count
and coarsening (Listing 7), with their host-side oracles.  No algorithm
touches the physical representation."""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from . import view as view_mod
from .graph import Graph, _degree_msg
from .pregel import PregelResult, pregel
from .tree import tree_flatten, tree_map, tree_unflatten

IMAX = 2**31 - 1
# "unreached" in SSSP: the f32 maximum, not +inf, whose sums and minima
# take other apply paths (the reference's own choice)
INF32 = float(np.finfo(np.float32).max)


def attach_out_degree(g: Graph, kernel_mode: str = "auto") -> Graph:
    """Out-degree as a 0-way-join mrTriplets (§4.5.2), stored as the `deg`
    leaf (at least 1).  Every other leaf's view state survives."""
    vals, exists, g, _ = g.mrTriplets(_degree_msg, "sum", to="src",
                                      kernel_mode=kernel_mode)
    deg = torch.where(exists, vals["deg"], 0.0)
    old = g.vdata if isinstance(g.vdata, dict) else {"v": g.vdata}
    vdata = {**old, "deg": torch.clamp_min(deg, 1.0)}
    view = view_mod.view_after_rewrite(
        g.view, old, vdata, view_mod.keep_through(old, exclude=("deg",)), None)
    return g.replace(vdata=vdata, view=view)


def pagerank_send(sv, ev, dv):
    """Synchronous PageRank message: the source's rank share."""
    return {"m": sv["pr"] / sv["deg"] * ev["w"]}


def delta_pagerank_send(sv, ev, dv):
    """Delta PageRank message: the source's rank change share."""
    return {"m": sv["delta"] / sv["deg"] * ev["w"]}


@functools.lru_cache(maxsize=64)
def pagerank_vprog(reset: float):
    """Synchronous PageRank vprog (one function object per `reset`, so the
    plan and kernel caches hit across calls)."""
    def vprog(vid, v, msg):
        return {**v, "pr": reset + (1.0 - reset) * msg["m"]}
    return vprog


@functools.lru_cache(maxsize=64)
def delta_pagerank_fns(reset: float, tol: float):
    """(vprog, changed_fn) of delta PageRank."""
    def vprog(vid, v, msg):
        new_pr = v["pr"] + (1.0 - reset) * msg["m"]
        return {**v, "pr": new_pr, "delta": new_pr - v["pr"]}

    def changed_fn(old, new):
        return torch.abs(new["pr"] - old["pr"]) > tol
    return vprog, changed_fn


def _pr_init(vid, v):
    return {**v, "pr": torch.tensor(1.0)}


def pagerank(g: Graph, *, num_iters: int = 20, reset: float = 0.15,
             tol: float = 0.0, kernel_mode: str = "auto",
             incremental: bool = True, track_metrics: bool = False,
             transport=None) -> PregelResult:
    """PageRank via Pregel.  The send UDF reads only source attributes, so
    the dst side of the join is eliminated.

    tol == 0: synchronous PageRank, every vertex recomputes
    reset + (1-reset)*msgSum each superstep.  tol > 0: delta PageRank —
    messages carry rank changes, so skipStale is exact under the sum.
    transport: the exchange's plan (`core.transport`), as in `pregel`."""
    g = attach_out_degree(g, kernel_mode)
    zero = {"m": torch.tensor(0.0)}
    if tol <= 0.0:
        return pregel(g.mapV(_pr_init), pagerank_vprog(reset), pagerank_send,
                      "sum", default_msg=zero, max_supersteps=num_iters,
                      skip_stale=None, incremental=incremental,
                      kernel_mode=kernel_mode, track_metrics=track_metrics,
                      transport=transport)
    g = g.mapV(lambda vid, v: {**v, "pr": torch.tensor(reset),
                               "delta": torch.tensor(reset)})
    vprog, changed_fn = delta_pagerank_fns(reset, tol)
    return pregel(g, vprog, delta_pagerank_send, "sum", default_msg=zero,
                  max_supersteps=num_iters, skip_stale="out",
                  incremental=incremental, changed_fn=changed_fn,
                  kernel_mode=kernel_mode, track_metrics=track_metrics,
                  transport=transport)


def pagerank_reference(src: np.ndarray, dst: np.ndarray, n: int,
                       num_iters: int = 20, reset: float = 0.15) -> np.ndarray:
    """Dense numpy float64 oracle (synchronous PR, uniform init 1.0)."""
    pr = np.ones(n, np.float64)
    deg = np.maximum(np.bincount(src, minlength=n), 1)
    for _ in range(num_iters):
        msg = np.bincount(dst, weights=(pr / deg)[src], minlength=n)
        pr = reset + (1 - reset) * msg
    return pr


def cc_send(sv, ev, dv):
    return {"m": sv["cc"]}


def cc_vprog(vid, v, msg):
    return {"cc": torch.minimum(v["cc"], msg["m"])}


def _cc_init(vid, v):
    return {"cc": vid}


def connected_components(g: Graph, *, max_supersteps: int = 100,
                         kernel_mode: str = "auto", incremental: bool = True,
                         track_metrics: bool = False,
                         transport=None) -> PregelResult:
    """Min-id label diffusion over a symmetrised edge set; transport as in
    `pregel`."""
    return pregel(g.mapV(_cc_init), cc_vprog, cc_send, "min",
                  default_msg={"m": torch.tensor(IMAX, dtype=torch.int32)},
                  max_supersteps=max_supersteps, skip_stale="out",
                  incremental=incremental, kernel_mode=kernel_mode,
                  track_metrics=track_metrics, transport=transport)


def connected_components_reference(src, dst, vids) -> dict[int, int]:
    """Union-find oracle: vertex id -> min id of its component."""
    parent = {int(v): int(v) for v in vids}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, d in zip(src, dst):
        rs, rd = find(int(s)), find(int(d))
        if rs != rd:
            parent[max(rs, rd)] = min(rs, rd)
    return {v: find(int(v)) for v in parent}


# --------------------------------------------------------------------------
# Single-source shortest paths
# --------------------------------------------------------------------------
def sssp_send(sv, ev, dv):
    return {"m": sv["dist"] + ev["w"]}


def sssp_vprog(vid, v, msg):
    return {"dist": torch.minimum(v["dist"], msg["m"])}


def sssp(g: Graph, source: int, *, max_supersteps: int = 100,
         kernel_mode: str = "auto") -> PregelResult:
    """Shortest distances from `source` over the edge weights `w`, by
    min-relaxation; unreached vertices keep INF32."""
    g = g.mapV(lambda vid, v: {"dist": torch.where(
        vid == source, torch.tensor(0.0), torch.tensor(INF32))})
    return pregel(g, sssp_vprog, sssp_send, "min",
                  default_msg={"m": torch.tensor(INF32)},
                  max_supersteps=max_supersteps, skip_stale="out",
                  kernel_mode=kernel_mode)


# --------------------------------------------------------------------------
# Label propagation (k-label voting, associative formulation)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def label_propagation_fns(k: int):
    """(send, vprog) of k-label voting, one object pair per k (the plan and
    kernel caches key on them).  The send's one-hot is a stack of k
    comparisons and the vprog an amax and an argmax, all of which the
    kernels' IR takes, so both plan fused.  Votes are counts >= 0, so a
    vertex has votes iff their largest is > 0 (the reference sums them; a
    float sum stays outside the IR, see `kernels.udf`)."""
    def send(sv, ev, dv):
        label = sv["label"] % k
        return {"votes": torch.stack([(label == j).to(torch.float32)
                                      for j in range(k)])}

    def vprog(vid, v, msg):
        has_votes = msg["votes"].amax() > 0
        new = torch.argmax(msg["votes"]).to(torch.int32)
        return {"label": torch.where(has_votes, new, v["label"])}
    return send, vprog


def label_propagation(g: Graph, num_labels: int, *, num_iters: int = 10,
                      kernel_mode: str = "auto") -> PregelResult:
    """Each vertex adopts the label most of its in-neighbours hold (the
    first on a tie) and keeps its own without votes; the `label` leaf
    (int32) must be set.  Votes are one-hot vectors, so the gather is a
    sum."""
    send, vprog = label_propagation_fns(num_labels)
    return pregel(g, vprog, send, "sum",
                  default_msg={"votes": torch.zeros(num_labels)},
                  max_supersteps=num_iters, skip_stale=None,
                  kernel_mode=kernel_mode)


def label_propagation_reference(src, dst, labels: np.ndarray, k: int,
                                num_iters: int) -> np.ndarray:
    """Numpy oracle of the same synchronous vote over compact ids."""
    lab = np.asarray(labels).copy()
    for _ in range(num_iters):
        votes = np.zeros((lab.shape[0], k), np.int64)
        np.add.at(votes, (dst, lab[src] % k), 1)
        lab = np.where(votes.sum(1) > 0, votes.argmax(1), lab).astype(
            lab.dtype)
    return lab


# --------------------------------------------------------------------------
# Triangle count: a 3-way-join workload
# --------------------------------------------------------------------------
_WORD = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (a SWAR count: torch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _WORD) >> 24


def _tri_vid(vid, v):
    return {"vid": vid}


@functools.lru_cache(maxsize=64)
def triangle_fns(w: int):
    """(send_bits, send_common) over bitsets of w 32-bit words.  The words
    ride int64 holding values in [0, 2^32): torch's uint32 lacks shifts and
    index_add_ on the CPU, and an int32 would pass the fused plan as
    id-valued and stage bit 31 through f32.  int64 sums never fuse, as the
    reference's uint32 never do."""
    def send_bits(sv, ev, dv):
        vid = sv["vid"].to(torch.int64)
        bit = torch.ones_like(vid) << (vid % 32)
        words = torch.arange(w, device=vid.device)
        return {"bits": torch.where(words == vid // 32, bit, 0)}

    def send_common(sv, ev, dv):
        inter = sv["bits"] & dv["bits"]
        return {"c": popcount32(inter).sum().to(torch.float32)}
    return send_bits, send_common


def triangle_count(g: Graph, *, n_ids: int | None = None,
                   kernel_mode: str = "auto"):
    """Triangles through the narrow waist, two mrTriplets passes.

    Phase 1 gathers each vertex's in-neighbour set as a bitset: every
    (deduplicated) edge sets a distinct bit at its destination, so the sum
    is an OR; sums are taken mod 2^32, so duplicate edges wrap as the
    reference's uint32 words do.  Phase 2 maps each edge to the popcount
    of the AND of its endpoints' sets and sums at the destination; on a
    symmetrised graph without self-loops each triangle counts twice at
    each corner.  Requires compact ids in [0, n_ids).  Returns
    (per_vertex [P, V_blk] f32, total f32, metrics)."""
    n_ids = n_ids or g.s.num_vertices
    send_bits, send_common = triangle_fns((n_ids + 31) // 32)
    g1 = g.mapV(_tri_vid)
    bits, exists, _, m1 = g1.mrTriplets(send_bits, "sum", to="dst",
                                        kernel_mode=kernel_mode)
    nbr = torch.where(exists[..., None], bits["bits"] & _WORD, 0)
    del bits
    g2 = g1.replace(vdata={"bits": nbr})
    cnts, exists2, _, m2 = g2.mrTriplets(send_common, "sum", to="dst",
                                         kernel_mode=kernel_mode)
    per_vertex = torch.where(exists2, cnts["c"], 0.0) / 2.0
    total = per_vertex.sum() / 3.0
    return per_vertex, total, {"phase1": m1, "phase2": m2}


def triangle_count_reference(src, dst, n: int) -> int:
    """Brute-force oracle on the symmetrised adjacency."""
    adj = [set() for _ in range(n)]
    for s, d in zip(src, dst):
        if s != d:
            adj[int(s)].add(int(d))
            adj[int(d)].add(int(s))
    total = 0
    for u in range(n):
        for v in adj[u]:
            if v > u:
                total += len((adj[u] & adj[v]) - {u, v})
    # each triangle is counted once per edge (u < v) that closes it
    return total // 3


# --------------------------------------------------------------------------
# Coarsen (paper Listing 7): the unified data- and graph-parallel pipeline
# --------------------------------------------------------------------------
_MERGE = {"sum": np.add, "min": np.minimum, "max": np.maximum}


def coarsen(g: Graph, epred: Callable, merge: str = "sum", *,
            kernel_mode: str = "auto") -> Graph:
    """Contract the edges that satisfy `epred`: vertices of one contracted
    component merge into a super-vertex whose id is the component's
    least id.  Listing 7: subgraph -> connected components -> reduceByKey
    -> rebuild.

    Vertex values merge (merge: sum|min|max) in the leaf's dtype, in
    `vertices_to_numpy` order from each component's first value, as the
    reference's host loop adds them; an edge survives unless its (src,
    dst) pair is among the subgraph's, and contraction's self-loops drop.
    The rebuild is a host stage (graphs are immutable)."""
    fn = _MERGE.get(merge)
    if fn is None:
        raise ValueError(f"merge={merge!r}; one of {tuple(_MERGE)}")
    sub = g.subgraph(epred=epred)
    cc = connected_components(sub, kernel_mode=kernel_mode).graph
    vids, cvals = cc.vertices_to_numpy()
    order = np.argsort(vids)
    ids_sorted, comp_sorted = vids[order], np.asarray(cvals["cc"])[order]

    def comp_of(x):
        return comp_sorted[np.searchsorted(ids_sorted, x)].astype(np.int64)

    gvids, gvals = g.vertices_to_numpy()
    super_keys, first, inv = np.unique(comp_of(gvids), return_index=True,
                                       return_inverse=True)
    rest = np.ones(gvids.shape[0], bool)
    rest[first] = False

    def merge_leaf(leaf):
        out = leaf[first].copy()
        fn.at(out, inv[rest], leaf[rest])
        return out

    leaves, spec = tree_flatten(gvals)
    super_vals = tree_unflatten([merge_leaf(l) for l in leaves], spec)

    esrc, edst, evals = g.edges_to_numpy()
    sub_src, sub_dst, _ = sub.edges_to_numpy()
    pair = lambda a, b: (a.astype(np.int64) << 32) | b.astype(np.int64)  # noqa: E731
    keep = ~np.isin(pair(esrc, edst), pair(sub_src, sub_dst))
    new_src, new_dst = comp_of(esrc[keep]), comp_of(edst[keep])
    loop = new_src == new_dst
    new_evals = tree_map(lambda e: e[keep][~loop], evals)
    default_v = tree_map(lambda a: np.zeros(a.shape[1:], a.dtype), super_vals)
    coarse = Graph.from_edges(
        new_src[~loop], new_dst[~loop], edge_values=new_evals,
        vertex_keys=super_keys, vertex_values=super_vals,
        default_vertex=default_v, num_partitions=g.s.p, device=g.device)
    return coarse.replace(ex=g.ex)
