"""Vertex-cut partitioning and routing tables (paper §4.2), in numpy.

The build-time half of the engine, ported from `repro.core.partition` with
every array byte-identical to the reference, except the Pallas chunk
tables (`tiles`).  Those grouped each partition's edges into 512-edge
chunks per (out-block, in-block) pair, padding every chunk to 512 slots so
TPU tiles stay dense; on a power-law graph the padding grows with the
graph (rmat(18,16): 18 slots per live edge).  A GPU gathers with indexed
loads and needs only row pointers, so `gpu_tables` builds:

  agg_ptr[side]   [P, V_mir+1] int32  CSR row pointers of each aggregation
                                      slot over the partition's live edges:
                                      "dst" over dst_slot (edges are stored
                                      dst-sorted), "src" over
                                      src_slot[src_perm] (the stable src sort)
  agg_perm[side]  [P, E_blk] int32    the edge order agg_ptr[side] walks:
                                      None for "dst" (the stored order),
                                      src_perm for "src"; reverse() swaps
                                      the sides, so a transposed graph's
                                      "dst" walks the old src_perm
  agg_pieces[side]                    the piece tables of agg_ptr[side]
                                      (`kernels/segorder.py`): each slot's
                                      CSR range cut into pieces of at most
                                      SEG_PIECE edges, the summation order
                                      the triplet and segment_sum kernels
                                      share
  apply_rng[side] [P, P, NB+1] int32 the route-range table of the fused
                                      apply (`kernels/applyroute.py`): where
                                      each granule of APPLY_GRAN home slots
                                      begins in the live prefix of
                                      routes[side][0][q, pe]

Layout of the shared arrays (P = number of partitions):
  src_slot / dst_slot [P, E_blk] int32   mirror slots, edges dst-clustered
  src_perm            [P, E_blk] int32   stable re-sort of edges by src_slot
  edge_mask           [P, E_blk] bool    live prefix of each edge slab
  mirror_vid          [P, V_mir] int32   global id per mirror slot (-1 pad)
  home_vid/home_mask  [P, V_blk]         id-sorted home rows (INT_PAD pad)
  routes[need]        (send [P,P,K], recv [P,P,K], K) for need in
                      {"src", "dst", "both"} (join elimination, §4.5.2)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels import applyroute, segorder
from .hashing import hash_mod, hash_mod32

INT_PAD = np.int32(2**31 - 1)  # sorts after every real id


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PartitionStats:
    """Replication statistics of one placement."""

    num_vertices: int
    num_edges: int
    num_partitions: int
    total_mirrors: int
    threshold: int | None = None
    bcast_min_repl: int | None = None
    n_broadcast: int = 0
    vertex_ids: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)
    replication: np.ndarray | None = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def replication_factor(self) -> float:
        return self.total_mirrors / max(self.num_vertices, 1)

    def replication_of(self, vids: np.ndarray) -> np.ndarray:
        """Per-vertex mirror counts for the given global ids."""
        idx = np.searchsorted(self.vertex_ids, np.asarray(vids))
        return self.replication[idx]


@dataclasses.dataclass(eq=False)
class GraphStructure:
    """Host-side (numpy) structural index of one partitioned graph."""

    num_partitions: int
    num_vertices: int
    num_edges: int
    e_blk: int
    v_mir: int
    v_blk: int
    k_route: int

    src_slot: np.ndarray
    dst_slot: np.ndarray
    src_perm: np.ndarray
    edge_mask: np.ndarray
    mirror_vid: np.ndarray
    home_vid: np.ndarray
    home_mask: np.ndarray
    routes: dict = None  # type: ignore[assignment]
    stats: PartitionStats = None  # type: ignore[assignment]
    edge_part: np.ndarray = None  # type: ignore[assignment]
    edge_row: np.ndarray = None   # type: ignore[assignment]
    # broadcast lane (built for parity; the port's exchange does not ship
    # through it yet)
    bsend: np.ndarray = None      # type: ignore[assignment]
    bcast_vid: np.ndarray = None  # type: ignore[assignment]
    brecv: dict = None            # type: ignore[assignment]
    p2p_routes: dict = None       # type: ignore[assignment]
    b_width: int = 0
    max_vid: int = 0
    # GPU tables in place of the Pallas tiles (see module docstring)
    agg_ptr: dict = None          # type: ignore[assignment]
    agg_pieces: dict = None       # type: ignore[assignment]
    # None on a built structure: {"dst": None, "src": src_perm}
    agg_perm: dict = None         # type: ignore[assignment]
    apply_rng: dict = None        # type: ignore[assignment]

    def home_of(self, vids: np.ndarray) -> np.ndarray:
        return hash_mod32(vids, self.num_partitions)

    def local_row(self, vids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(partition, row) of each vertex id in its home partition."""
        part = self.home_of(vids)
        rows = np.empty_like(part)
        for q in np.unique(part):
            sel = part == q
            rows[sel] = np.searchsorted(self.home_vid[q], vids[sel])
        return part, rows


def edge_partition_2d(src: np.ndarray, dst: np.ndarray, p: int) -> np.ndarray:
    """2D hash partitioner: edge (s, d) -> cell (h(s) mod R, h(d) mod C) of
    an R x C = P grid, bounding replication by O(sqrt(P))."""
    r = int(np.floor(np.sqrt(p)))
    while p % r != 0:
        r -= 1
    c = p // r
    hs = hash_mod(src, r, salt=0x5EED)
    hd = hash_mod(dst, c, salt=0xF00D)
    return hs * c + hd


def edge_partition_1d(src: np.ndarray, dst: np.ndarray, p: int) -> np.ndarray:
    """Edge-cut style hash of the source endpoint."""
    del dst
    return hash_mod(src, p, salt=0x5EED)


def random_partition(src: np.ndarray, dst: np.ndarray, p: int) -> np.ndarray:
    """Random edge placement."""
    return hash_mod(src * np.int64(1315423911) + dst, p, salt=0xABCD)


def _edge_source_degree(src: np.ndarray) -> np.ndarray:
    """Per-EDGE out-degree of the edge's source vertex."""
    if src.size == 0:
        return np.zeros(0, np.int64)
    _, inv, cnt = np.unique(src, return_inverse=True, return_counts=True)
    return cnt[inv]


def _mirror_total(src: np.ndarray, dst: np.ndarray, epart: np.ndarray,
                  p: int) -> int:
    """Total mirrors (distinct (vertex, partition) pairs) of a placement."""
    key = (np.concatenate([src, dst]).astype(np.int64) * p
           + np.tile(np.asarray(epart, np.int64), 2))
    return int(np.unique(key).size)


def choose_hybrid_threshold(src: np.ndarray, dst: np.ndarray,
                            p: int) -> int:
    """Degree threshold of the hybrid cut minimising total mirrors over a
    log-spaced sweep (0 = pure 2D, max_degree+1 = pure 1D)."""
    deg = _edge_source_degree(src)
    max_deg = int(deg.max()) if deg.size else 1
    cands, t = [0], 1
    while t <= max_deg:
        cands.append(t)
        t *= 2
    cands.append(max_deg + 1)
    d1 = edge_partition_1d(src, dst, p)
    d2 = edge_partition_2d(src, dst, p)
    best_t, best_m = 0, None
    for cand in cands:
        m = _mirror_total(src, dst, np.where(deg < cand, d1, d2), p)
        if best_m is None or m < best_m:
            best_t, best_m = int(cand), m
    return best_t


def edge_partition_hybrid(src: np.ndarray, dst: np.ndarray, p: int,
                          threshold: int | None = None) -> np.ndarray:
    """Degree-aware hybrid cut: sources below `threshold` place 1D, hubs 2D."""
    if threshold is None:
        threshold = choose_hybrid_threshold(src, dst, p)
    deg = _edge_source_degree(src)
    return np.where(deg < threshold,
                    edge_partition_1d(src, dst, p),
                    edge_partition_2d(src, dst, p))


PARTITIONERS = {
    "2d": edge_partition_2d,
    "1d": edge_partition_1d,
    "random": random_partition,
    "hybrid": edge_partition_hybrid,
}


def gpu_tables(src_slot: np.ndarray, dst_slot: np.ndarray,
               src_perm: np.ndarray, edge_mask: np.ndarray, routes: dict,
               v_mir: int, v_blk: int) -> tuple[dict, dict, dict]:
    """(agg_ptr, agg_pieces, apply_rng) — the CSR, piece and route-range
    tables the CUDA kernels index (module docstring), "dst" over the stored
    order and "src" over src_perm's.  Requires each partition's live edges
    to be the dst-sorted prefix of its slab and each route row's live
    entries to be a strictly increasing prefix, as build_structure lays
    them out (a transposed structure carries its swapped tables instead);
    raises ValueError otherwise."""
    p = src_slot.shape[0]
    n = edge_mask.sum(axis=1)
    if not np.array_equal(edge_mask,
                          np.arange(edge_mask.shape[1])[None, :] < n[:, None]):
        raise ValueError("edge_mask must mark a prefix of each edge slab")
    if any(np.any(np.diff(dst_slot[q, :n[q]]) < 0) for q in range(p)):
        raise ValueError("the live edges must be sorted by dst_slot")
    slots = np.arange(v_mir + 1)
    dptr = np.zeros((p, v_mir + 1), np.int32)
    sptr = np.zeros((p, v_mir + 1), np.int32)
    for q in range(p):
        dptr[q] = np.searchsorted(dst_slot[q, :n[q]], slots)
        sptr[q] = np.searchsorted(src_slot[q][src_perm[q]][:n[q]], slots)
    apply_rng = {side: applyroute.route_ranges(routes[side][0], v_blk)
                 for side in ("dst", "src")}
    agg_ptr = {"dst": dptr, "src": sptr}
    agg_pieces = {k: segorder.piece_tables(v) for k, v in agg_ptr.items()}
    return agg_ptr, agg_pieces, apply_rng


def build_structure(
    src: np.ndarray,
    dst: np.ndarray,
    num_partitions: int,
    *,
    vertex_ids: np.ndarray | None = None,
    partitioner: str = "2d",
    pad_multiple: int = 8,
    hybrid_threshold: int | None = None,
    bcast_min_repl: int | None = None,
) -> GraphStructure:
    """Partition the edge list and build every structural index.

    `vertex_ids` may include isolated vertices (home rows, no mirrors).
    partitioner: "2d" | "1d" | "random" | "hybrid"; `bcast_min_repl`
    classifies the broadcast set (vertices on >= that many partitions)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be 1-D arrays of equal length")
    p = int(num_partitions)
    n_edges = int(src.shape[0])

    all_vids = np.unique(np.concatenate([src, dst]))
    if vertex_ids is not None:
        all_vids = np.unique(np.concatenate(
            [all_vids, np.asarray(vertex_ids, np.int64)]))
    if all_vids.size and (all_vids.min() < 0 or all_vids.max() >= INT_PAD):
        raise ValueError("vertex ids must fit int32 and be non-negative "
                         "(ingest with dictionary encoding first)")
    n_vertices = int(all_vids.size)

    # ---- home partitions (hash by id, sorted within partition) ----------
    home = hash_mod32(all_vids, p)
    v_blk = _round_up(max(int(np.max(np.bincount(home, minlength=p)))
                          if n_vertices else 1, 1), pad_multiple)
    home_vid = np.full((p, v_blk), INT_PAD, dtype=np.int32)
    home_mask = np.zeros((p, v_blk), dtype=bool)
    for q in range(p):
        mine = np.sort(all_vids[home == q]).astype(np.int32)
        home_vid[q, : mine.size] = mine
        home_mask[q, : mine.size] = True

    # ---- edge partitions + mirror tables ---------------------------------
    threshold = None
    if partitioner == "hybrid":
        threshold = (hybrid_threshold if hybrid_threshold is not None
                     else choose_hybrid_threshold(src, dst, p))
        epart = edge_partition_hybrid(src, dst, p, threshold=threshold)
    else:
        epart = PARTITIONERS[partitioner](src, dst, p)
    counts = np.bincount(epart, minlength=p)
    e_blk = _round_up(max(int(counts.max()) if n_edges else 1, 1), pad_multiple)

    mirrors: list[np.ndarray] = []
    for q in range(p):
        sel = epart == q
        mirrors.append(np.unique(np.concatenate([src[sel], dst[sel]])).astype(np.int32))
    v_mir = _round_up(max(max((m.size for m in mirrors), default=1), 1), pad_multiple)

    src_slot = np.zeros((p, e_blk), dtype=np.int32)
    dst_slot = np.zeros((p, e_blk), dtype=np.int32)
    src_perm = np.tile(np.arange(e_blk, dtype=np.int32), (p, 1))
    edge_mask = np.zeros((p, e_blk), dtype=bool)
    mirror_vid = np.full((p, v_mir), -1, dtype=np.int32)
    edge_part = np.zeros(n_edges, dtype=np.int32)
    edge_row = np.zeros(n_edges, dtype=np.int32)

    for q in range(p):
        sel = np.flatnonzero(epart == q)
        m = mirrors[q]
        mirror_vid[q, : m.size] = m
        s_loc = np.searchsorted(m, src[sel]).astype(np.int32)
        d_loc = np.searchsorted(m, dst[sel]).astype(np.int32)
        # cluster by destination slot (stable, keeps src runs cache-friendly)
        order = np.argsort(d_loc, kind="stable")
        s_loc, d_loc = s_loc[order], d_loc[order]
        n = sel.size
        src_slot[q, :n] = s_loc
        dst_slot[q, :n] = d_loc
        edge_mask[q, :n] = True
        edge_part[sel[order]] = q
        edge_row[sel[order]] = np.arange(n, dtype=np.int32)
        perm = np.argsort(np.where(edge_mask[q], src_slot[q], INT_PAD), kind="stable")
        src_perm[q] = perm.astype(np.int32)

    # ---- routing tables (per need set, for join elimination §4.5.2) -------
    need_flags: dict[str, list[np.ndarray]] = {"src": [], "dst": [], "both": []}
    for q in range(p):
        sel = epart == q
        m = mirrors[q]
        is_src = np.isin(m, src[sel])
        is_dst = np.isin(m, dst[sel])
        need_flags["src"].append(is_src)
        need_flags["dst"].append(is_dst)
        need_flags["both"].append(is_src | is_dst)

    def build_route(flags: list[np.ndarray]):
        send_lists: list[list[np.ndarray]] = [[None] * p for _ in range(p)]  # type: ignore
        recv_lists: list[list[np.ndarray]] = [[None] * p for _ in range(p)]  # type: ignore
        k_route = 1
        for pe in range(p):
            m = mirrors[pe][flags[pe]]
            mslot = np.arange(mirrors[pe].size, dtype=np.int32)[flags[pe]]
            vhome = hash_mod32(m, p)
            for q in range(p):
                sel = vhome == q
                rows = np.searchsorted(home_vid[q], m[sel]).astype(np.int32)
                send_lists[q][pe] = rows
                recv_lists[pe][q] = mslot[sel]
                k_route = max(k_route, rows.size)
        k_route = _round_up(k_route, pad_multiple)
        send = np.full((p, p, k_route), -1, dtype=np.int32)
        recv = np.full((p, p, k_route), v_mir, dtype=np.int32)  # OOB pad
        for q in range(p):
            for pe in range(p):
                rows = send_lists[q][pe]
                slots = recv_lists[pe][q]
                send[q, pe, : rows.size] = rows
                recv[pe, q, : slots.size] = slots
        return send, recv, k_route

    routes = {need: build_route(flags) for need, flags in need_flags.items()}
    k_route = routes["both"][2]

    # ---- per-vertex replication + broadcast-set classification ------------
    repl = np.zeros(max(n_vertices, 1), np.int32)
    for q in range(p):
        if mirrors[q].size:
            repl[np.searchsorted(all_vids, mirrors[q])] += 1

    bsend = bcast_vid = brecv = p2p_routes = None
    b_width = 0
    n_broadcast = 0
    if bcast_min_repl is not None and n_vertices:
        bvids = all_vids[repl[:n_vertices] >= int(bcast_min_repl)]
        n_broadcast = int(bvids.size)
        if n_broadcast:
            bhome = hash_mod32(bvids, p)
            b_width = _round_up(
                max(int(np.bincount(bhome, minlength=p).max()), 1),
                pad_multiple)
            bsend = np.full((p, b_width), -1, np.int32)
            bcast_vid = np.full((p, b_width), -1, np.int32)
            bq_of = {}
            for q in range(p):
                bq = bvids[bhome == q]
                bq_of[q] = bq
                bsend[q, : bq.size] = np.searchsorted(
                    home_vid[q], bq).astype(np.int32)
                bcast_vid[q, : bq.size] = bq.astype(np.int32)
            brecv = {}
            for need, flags in need_flags.items():
                tbl = np.full((p, p, b_width), v_mir, np.int32)
                for pe in range(p):
                    m = mirrors[pe]
                    for q in range(p):
                        bq = bq_of[q]
                        if not (m.size and bq.size):
                            continue
                        pos = np.searchsorted(m, bq)
                        inb = pos < m.size
                        pos2 = np.where(inb, pos, 0)
                        ok = inb & (m[pos2] == bq) & flags[pe][pos2]
                        row = tbl[pe, q, : bq.size]
                        row[ok] = pos2[ok].astype(np.int32)
                brecv[need] = tbl
            p2p_routes = {
                need: build_route(
                    [f & ~np.isin(mirrors[pe], bvids)
                     for pe, f in enumerate(flags)])
                for need, flags in need_flags.items()}

    agg_ptr, agg_pieces, apply_rng = gpu_tables(
        src_slot, dst_slot, src_perm, edge_mask, routes, v_mir, v_blk)
    stats = PartitionStats(
        num_vertices=n_vertices,
        num_edges=n_edges,
        num_partitions=p,
        total_mirrors=int(sum(m.size for m in mirrors)),
        threshold=threshold,
        bcast_min_repl=bcast_min_repl,
        n_broadcast=n_broadcast,
        vertex_ids=all_vids,
        replication=repl[:n_vertices],
    )
    return GraphStructure(
        num_partitions=p,
        num_vertices=n_vertices,
        num_edges=n_edges,
        e_blk=e_blk,
        v_mir=v_mir,
        v_blk=v_blk,
        k_route=k_route,
        src_slot=src_slot,
        dst_slot=dst_slot,
        src_perm=src_perm,
        edge_mask=edge_mask,
        mirror_vid=mirror_vid,
        home_vid=home_vid,
        home_mask=home_mask,
        routes=routes,
        stats=stats,
        edge_part=edge_part,
        edge_row=edge_row,
        bsend=bsend,
        bcast_vid=bcast_vid,
        brecv=brecv,
        p2p_routes=p2p_routes,
        b_width=b_width,
        max_vid=int(all_vids.max()) if n_vertices else 0,
        agg_ptr=agg_ptr,
        agg_pieces=agg_pieces,
        apply_rng=apply_rng,
    )
