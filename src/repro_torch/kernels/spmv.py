"""SpMV on the GPU: the linear-message instance of the triplet kernel.

Replaces `src/repro/kernels/spmv.py:spmv`, which runs the fused triplet
kernel's pallas_call (`src/repro/kernels/triplet.py:447`) with the message
w * x[src]; here it runs csrc/triplet.cu the same way:

    out[v] = sum over live edges e with dst(e) = v of w[e] * x[src(e)]

`active_src_blocks` keeps the reference's block-level skipStale: an edge is
live iff `active[src // vb]`.  In place of the Pallas chunk tiles,
`build_tiles` returns CSR tables built once in numpy: `ptr [V+1]` row
pointers over the destinations, `perm [E]`, the structurally live edges
in ascending (dst, edge index) order, which the kernel walks per
destination, and the piece tables of `ptr` (`piece_ptr`, `piece_seg`,
`piece_multi`; `kernels/segorder.py`), which fix the f32 summation order.
Bytes bound it, as the triplet kernel.  On CPU tensors it runs the triplet
kernel's plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ref, segorder, udf
from . import triplet as _triplet


@functools.lru_cache(maxsize=16)
def linear_message(d: int) -> _triplet.TripletUdf:
    """The message x[src][j] * w for j < d (`spmv.py:_linear_message`)."""
    ops = [udf.Op("in", ("ev", 0), "f32")]
    outs = []
    for j in range(d):
        ops.append(udf.Op("in", ("xs", j), "f32"))
        ops.append(udf.Op("mul", (len(ops) - 1, 0), "f32"))
        outs.append(len(ops) - 1)
    return _triplet.TripletUdf(udf.IR(tuple(ops), tuple(outs)), d)


def build_tiles(src_slot: np.ndarray, dst_slot: np.ndarray,
                edge_mask: np.ndarray, v_mir: int) -> dict[str, np.ndarray]:
    """CSR tables of the structurally live edges (numpy, int32): ptr
    [v_mir + 1] over the destinations, perm [E] the live edges sorted by
    destination (stable), padded with 0 past ptr[v_mir], and the piece
    tables of ptr as one partition (piece_ptr [1, v_mir + 1], piece_seg
    [1, NP], piece_multi [M])."""
    dst = np.asarray(dst_slot)
    live = np.flatnonzero(np.asarray(edge_mask, bool))
    hi = max(int(dst[live].max()), int(np.asarray(src_slot)[live].max())) \
        if live.size else -1
    if hi >= v_mir:
        raise ValueError(f"slot {hi} outside the declared slot space "
                         f"[0, {v_mir})")
    order = live[np.argsort(dst[live], kind="stable")]
    perm = np.zeros(dst.shape[0], np.int32)
    perm[:order.size] = order
    ptr = np.zeros(v_mir + 1, np.int32)
    np.cumsum(np.bincount(dst[live], minlength=v_mir), out=ptr[1:])
    pieces = segorder.piece_tables(ptr[None])
    return {"ptr": ptr, "perm": perm, "piece_ptr": pieces.ptr,
            "piece_seg": pieces.seg, "piece_multi": pieces.multi}


def live_edges(src_slot: torch.Tensor, active_src_blocks, vb: int,
               n: int) -> torch.Tensor:
    """The live mask: every edge, or those whose source block is active."""
    if active_src_blocks is None:
        return torch.ones(n, dtype=torch.bool, device=src_slot.device)
    return active_src_blocks.to(src_slot.device)[src_slot.long() // vb]


def plain(x, w, src_slot, dst_slot, tiles, active_src_blocks, v_mir: int,
          *, vb: int = 512):
    """The plain version: a gather, a multiply and an index_add_ over the
    live edges (`ref.fused_gather_segment_sum` with the skip applied)."""
    keep = live_edges(src_slot, active_src_blocks, vb, w.shape[0])
    return ref.fused_gather_segment_sum(x, torch.where(keep, w, 0.0),
                                        src_slot, dst_slot, v_mir)


_TABLES = ("ptr", "perm", "piece_ptr", "piece_seg", "piece_multi")


def spmv(x: torch.Tensor, w: torch.Tensor, src_slot: torch.Tensor,
         dst_slot: torch.Tensor, tiles: dict, active_src_blocks, v_mir: int,
         *, vb: int = 512) -> torch.Tensor:
    """out [v_mir, D] f32 from x [v_mir, D], w [E], src_slot/dst_slot [E]
    int32, the `build_tiles` tables, and an optional [n_src_blocks] bool."""
    dev = x.device
    e = w.shape[0]
    live = live_edges(src_slot, active_src_blocks, vb, e)
    ptr, perm, *pieces = (torch.as_tensor(tiles[k], device=dev)
                          .to(torch.int32) for k in _TABLES)
    out, _ = _triplet.fused_triplet(
        x.float().contiguous(), w.float().reshape(e, 1).contiguous(),
        src_slot.to(torch.int32).reshape(1, e).contiguous(),
        dst_slot.to(torch.int32).reshape(1, e).contiguous(),
        live.reshape(1, e).contiguous(), ptr.reshape(1, -1),
        perm.reshape(1, e), linear_message(x.shape[1]), to="dst",
        reduce="sum", pieces=segorder.Pieces(*pieces))
    if dev.type == "cuda":
        spmv.launches += 1
    return out


spmv.launches = 0
