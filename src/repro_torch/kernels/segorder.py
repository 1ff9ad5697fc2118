"""The summation order of the CSR segment reductions, and its piece tables.

`csrc/segorder.cuh` states the order; this module holds its constant for
Python and builds the tables the kernels walk.  A segment (one aggregation
slot's CSR range [ptr[v], ptr[v+1])) is cut into pieces at ptr[v] + k *
SEG_PIECE; a segment no longer than SEG_PIECE is one piece, an empty one
too.  The cut reads the row pointers alone, never the live mask, so the
tables are built once per graph (numpy, next to `agg_ptr`):

  ptr   [P, V+1] int32  first piece of each segment, per partition
  seg   [P, NP]  int32  segment of each piece, -1 past the partition's last
                        (NP a multiple of 32: a warp's 32 pieces never
                        straddle two partitions)
  multi [M]      int32  flat ids q * V + v of the segments cut into more
                        than one piece, ascending

Numpy only: `core/partition.py` builds them with the rest of the structure.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

# SEG_PIECE of csrc/segorder.cuh (a CPU test reads the header to hold the
# two equal).  Chosen by scripts/seg_piece_sweep.py on the card.
SEG_PIECE = 32
WARP = 32


class Pieces(NamedTuple):
    """The piece tables of one aggregation side (module docstring); numpy
    arrays on the host, tensors on the device."""

    ptr: Any
    seg: Any
    multi: Any


def piece_tables(ptr: np.ndarray) -> Pieces:
    """Pieces of the CSR segments of row pointers ptr [P, V+1]."""
    ptr = np.asarray(ptr, np.int64)
    p, v = ptr.shape[0], ptr.shape[1] - 1
    n = np.maximum(1, -(-np.diff(ptr, axis=1) // SEG_PIECE))    # [P, V]
    pptr = np.zeros((p, v + 1), np.int64)
    np.cumsum(n, axis=1, out=pptr[:, 1:])
    n_max = int(pptr[:, -1].max()) if p else 0
    seg = np.full((p, max(-(-n_max // WARP), 1) * WARP), -1, np.int32)
    for q in range(p):
        seg[q, :pptr[q, -1]] = np.repeat(np.arange(v, dtype=np.int32), n[q])
    multi = np.flatnonzero(n.reshape(-1) > 1).astype(np.int32)
    return Pieces(pptr.astype(np.int32), seg, multi)


def spans(ptr: np.ndarray, pieces: Pieces) -> tuple[np.ndarray, ...]:
    """(partition, segment, begin, end) of every piece, in table order:
    the CSR positions each piece covers."""
    ptr = np.asarray(ptr, np.int64)
    pptr, seg = np.asarray(pieces.ptr, np.int64), np.asarray(pieces.seg)
    q, k = np.nonzero(seg >= 0)
    v = seg[q, k].astype(np.int64)
    begin = ptr[q, v] + (k - pptr[q, v]) * SEG_PIECE
    end = np.minimum(begin + SEG_PIECE, ptr[q, v + 1])
    return q, v, begin, end
