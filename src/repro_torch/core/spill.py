"""Out-of-core vertex partitions (the port of `repro.core.spill`, DESIGN.md
§2.4): cold home-vertex cells spill to pinned host memory between
supersteps and stream back before the next.

`pregel(working_set_frac=f)` splits every partition's home slots into
SPILL_BLOCK-row cells, ranks them by the active-set occupancy the
vote-to-halt loop keeps, and keeps the hottest `f` of them resident:

  * `spill(g)`, after a superstep: the coldest cells' rows are gathered on
    the device into one staging buffer per leaf, copied to a pinned host
    buffer without blocking (ordered by a recorded event), and their
    device rows zeroed in place;
  * `restore(g)`, before the next: the host rows copy back to the device
    and scatter into the same rows in place.  Values round-trip bit for
    bit, so the superstep is unchanged.

On a graph sharded over an `SpmdExchange` (`core/shard.py`) each rank
keeps a ring over its own rows: the plan is the global graph's, restricted
to the rank's rows, and the coldest cells are chosen from the gathered
active mask, so the cells spilled, and the resident and streamed bytes
summed over the ranks, are those of the unsharded graph.

In place, because the drivers' replays read the carry from their own
buffers: a spill that returned new tensors would leave a replay reading
stale rows.  The ring never writes a tensor the caller handed in
(`own` clones the vertex data once, before the first superstep).

The byte counts (`stream_bytes`, `resident_bytes`, `host_bytes`) are the
reference's.  Its times are modelled; here the model uses the card's
rates (`HBM_BW`, `HOST_LINK_BW`) and `chip_smoke.py` measures the copies
beside it.  The reference's ring cannot overlap its own order: the restore
before superstep s+1 needs the cells the spill after s moved, so
`stream_time_overlap` is the model's double-buffered bound, not a claim.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .exchange import spmd_of
from .tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit): the device memory rate
HBM_BW = 3.35e12
# Rows per (partition, cell) residency unit: the kernel vertex block
SPILL_BLOCK = 512
# The same card's host link, PCIe Gen5 x16: 64 GB/s per direction nominal
HOST_LINK_BW = 64e9
# Double buffering in the model: one buffer computes while one streams
PREFETCH_DEPTH = 2
# Time each spill's and restore's copies to their completion on the card
# (a sync before and after each; `pregel`'s records then carry
# `spill_copy_ms` / `restore_copy_ms`).  Off: the copies never block.
TIME_COPIES = False


def _leaf_bytes(x) -> int:
    return int(x.numel() * x.element_size())


def vdata_nbytes(vdata) -> int:
    return sum(_leaf_bytes(leaf) for leaf in tree_leaves(vdata))


def modeled_compute_time(g) -> float:
    """Memory-bound estimate of one superstep's device time: the mirror and
    home vertex data a few times and the edge tables once."""
    vb = vdata_nbytes(g.vdata)
    eb = sum(_leaf_bytes(leaf) for leaf in tree_leaves(g.edata))
    eb += _leaf_bytes(g.emask)
    return (3 * vb + eb) / HBM_BW


@dataclasses.dataclass(frozen=True)
class SpillPlan:
    """Static cell geometry of one graph."""

    nl: int                 # partition rows in the stacked layout
    v_blk: int              # home slots per partition
    block: int              # rows per cell
    n_cells: int            # cells per partition row
    n_cold: int             # cells spilled per rotation (global)
    row0: int = 0           # the first of the rows this executor holds
    rows: int | None = None  # how many it holds (None: all nl)

    @property
    def n_total(self) -> int:
        return self.nl * self.n_cells


def plan_spill(g, working_set_frac: float,
               block: int = SPILL_BLOCK) -> SpillPlan:
    if not 0.0 < working_set_frac <= 1.0:
        raise ValueError(
            f"working_set_frac must be in (0, 1], got {working_set_frac}")
    nl, v_blk = g.active.shape
    spmd = spmd_of(getattr(g, "ex", None))
    row0, rows = 0, None
    if spmd is not None:
        # a rank's share of a sharded graph: the global plan, its rows
        row0, rows, nl = spmd.rank * nl, nl, spmd.p
    # granularity guard: halve the cell until each partition row has at
    # least 4 cells (floor 64 rows), so "the coldest half" is not a stub
    while block > 64 and -(-v_blk // block) < 4:
        block //= 2
    n_cells = max(-(-v_blk // block), 1)
    total = nl * n_cells
    n_cold = total - max(int(np.ceil(working_set_frac * total)), 1)
    return SpillPlan(nl=nl, v_blk=v_blk, block=block,
                     n_cells=n_cells, n_cold=max(n_cold, 0), row0=row0,
                     rows=rows)


def choose_cold(plan: SpillPlan, active: np.ndarray) -> list[tuple[int, int]]:
    """Cells by active-set occupancy, coldest first; ties broken by
    (partition, cell), so re-runs pick the same set."""
    if plan.n_cold == 0:
        return []
    active = np.asarray(active)
    if plan.v_blk == 0:
        occ = np.zeros((plan.nl, 1))
    else:
        # each cell's mean as the reference's np.mean gives it: an exact
        # integer count over the cell's row count
        starts = np.arange(0, plan.v_blk, plan.block)
        counts = np.add.reduceat(active.astype(np.int64), starts, axis=1)
        sizes = np.minimum(starts + plan.block, plan.v_blk) - starts
        occ = counts / sizes
    ls, cs = np.meshgrid(np.arange(plan.nl), np.arange(plan.n_cells),
                         indexing="ij")
    order = np.lexsort((cs.ravel(), ls.ravel(), occ.ravel()))
    return [(int(ls.flat[i]), int(cs.flat[i]))
            for i in order[:plan.n_cold]]


def _cold_rows(plan: SpillPlan, cold) -> np.ndarray:
    """Flat row indices (local partition * v_blk + row) of the cold cells
    this executor holds, in the order they are stored."""
    lo = plan.row0
    hi = lo + (plan.nl if plan.rows is None else plan.rows)
    out = [(l - lo) * plan.v_blk
           + np.arange(c * plan.block, min((c + 1) * plan.block, plan.v_blk))
           for l, c in sorted(cold) if lo <= l < hi]
    return (np.concatenate(out) if out else np.empty(0, np.int64)).astype(
        np.int64)


@dataclasses.dataclass
class SpillRing:
    """Pinned host store of the cold cells and the modelled streaming
    accountant.  `store` holds, per leaf, the spilled rows [n, ...] of the
    cold cells; `rows` their flat device rows."""

    plan: SpillPlan
    store: list = dataclasses.field(default_factory=list)
    rows: torch.Tensor | None = None
    # bytes streamed by the last restore / spill pair (one rotation)
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    # host seconds of the last spill's and restore's copies, measured to
    # the copy's completion on the card (when `timed`)
    timed: bool = dataclasses.field(default_factory=lambda: TIME_COPIES)
    spill_s: float = 0.0
    restore_s: float = 0.0
    _event: object = None

    # ------------------------------------------------------------- residency
    def resident_bytes(self, g) -> int:
        """Device bytes of the vertex data after the spill: all of it less
        the host-held cells (the footprint the reference reports)."""
        return vdata_nbytes(g.vdata) - self.host_bytes()

    def host_bytes(self) -> int:
        return sum(_leaf_bytes(b) for b in self.store)

    # ------------------------------------------------------------- data plane
    @staticmethod
    def own(g):
        """`g` over its own copy of the vertex data, which the ring may
        write in place (the view stays: the values are the same)."""
        return g.replace(vdata=tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format),
            g.vdata), view=g.view)

    @staticmethod
    def _flat(leaf: torch.Tensor) -> torch.Tensor:
        """[nl, V, ...] -> [nl * V, ...], the same memory (in place)."""
        if not leaf.is_contiguous():
            raise ValueError("the spill ring writes its leaves in place and "
                             "needs them contiguous")
        return leaf.view((-1,) + tuple(leaf.shape[2:]))

    def _merge_into(self, leaves: list) -> int:
        """Copy the stored rows back into `leaves` (in place); bytes."""
        n_in = 0
        for leaf, host in zip(leaves, self.store):
            dev = host.to(leaf.device, non_blocking=True)
            self._flat(leaf).index_copy_(0, self.rows, dev)
            n_in += _leaf_bytes(host)
        return n_in

    def _tick(self, device: torch.device):
        """The host clock after the card's queued work, when `timed`."""
        if not self.timed:
            return None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def restore(self, g):
        """Before a superstep: every spilled row streams back into the
        device rows it left, and the host store empties."""
        if not self.store:
            self.bytes_in = 0.0
            self.restore_s = 0.0
            return g
        leaves, _ = tree_flatten(g.vdata)
        dev = leaves[0].device
        t0 = self._tick(dev)
        if self._event is not None:
            # the spill's copies land before these read the host rows: a
            # wait on the device, not on the host
            torch.cuda.current_stream().wait_event(self._event)
        self.bytes_in = float(self._merge_into(leaves))
        if t0 is not None:
            self.restore_s = self._tick(dev) - t0
        self.store, self.rows, self._event = [], None, None
        return g

    def peek(self, g):
        """The full graph for a snapshot, without draining the ring: copies
        of the device leaves with the host rows merged in."""
        if not self.store:
            return g
        if self._event is not None:
            torch.cuda.current_stream().wait_event(self._event)
        leaves, treedef = tree_flatten(g.vdata)
        leaves = [leaf.clone() for leaf in leaves]
        self._merge_into(leaves)
        return g.replace(vdata=tree_unflatten(leaves, treedef), view=g.view)

    def spill(self, g):
        """After a superstep: copy the coldest cells (by g.active) to pinned
        host memory and zero their device rows in place.  Returns g, whose
        vertex data now holds only the working set."""
        if self.plan.n_cold == 0:
            self.bytes_out = 0.0
            self.spill_s = 0.0
            return g
        leaves, _ = tree_flatten(g.vdata)
        dev = leaves[0].device
        t0 = self._tick(dev)
        active = (g.active if self.plan.rows is None
                  else g.ex.all_gather_rows(g.active)[0])
        cold = choose_cold(self.plan, active.cpu().numpy())
        rows = torch.from_numpy(_cold_rows(self.plan, cold)).to(dev)
        store = []
        for leaf in leaves:
            flat = self._flat(leaf)
            staged = flat.index_select(0, rows)
            host = torch.empty(staged.shape, dtype=staged.dtype,
                               pin_memory=dev.type == "cuda")
            host.copy_(staged, non_blocking=True)
            flat.index_fill_(0, rows, 0)
            store.append(host)
        if dev.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()
        self.store, self.rows = store, rows
        self.bytes_out = float(self.host_bytes())
        if t0 is not None:
            self.spill_s = self._tick(dev) - t0
        return g

    def materialize(self, g):
        """The exit seam: merge the host store back (and drop it)."""
        return self.restore(g)

    # ------------------------------------------------------------- time model
    def stream_times(self, g) -> dict:
        """Modelled time of the last rotation: serial = compute, then the
        rotation's bytes over the host link; overlap = the larger of the
        two (a double-buffered ring's bound)."""
        t_c = modeled_compute_time(g)
        stream_bytes = self.bytes_in + self.bytes_out
        t_s = stream_bytes / HOST_LINK_BW
        return {
            "stream_bytes": stream_bytes,
            "compute_time_modeled": t_c,
            "stream_time_serial": t_c + t_s,
            "stream_time_overlap": max(t_c, t_s),
        }
