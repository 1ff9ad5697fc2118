"""The route-range table of the fused Pregel apply (`csrc/apply.cu`).

The aggregate-return route `send[q, pe, :]` lists, for home partition q and
source partition pe, the home slot that each route entry j carries back to.
Its live entries are a prefix of the row (-1 pads the rest), and the prefix
is strictly increasing in the home slot: the route is built by
`np.searchsorted(home_vid[q], ...)` over id-sorted mirrors.  So the entries
that land in a range of home slots are one contiguous span of j.  The table

  apply_rng [P, P, NB + 1] int32, NB = ceil(V_blk / APPLY_GRAN)
  apply_rng[q, pe, b] = the first j of the live prefix whose home slot is
                        >= b * APPLY_GRAN (the live count for b = NB)

gives those spans at a granule of APPLY_GRAN slots: a CTA that owns home
slots [b0 * APPLY_GRAN, b1 * APPLY_GRAN) of partition q walks the entries
[apply_rng[q, pe, b0], apply_rng[q, pe, b1]) of each source partition pe.

Numpy only: `core/partition.py` builds the table with the rest of the
structure.
"""
from __future__ import annotations

import numpy as np

# APPLY_GRAN of csrc/applyroute.cuh (a CPU test reads the header to hold the
# two equal).  A CTA owns a multiple of it (`kernels/superstep.plan`).
APPLY_GRAN = 64


def route_ranges(send: np.ndarray, v_blk: int) -> np.ndarray:
    """apply_rng of one route side `send` [P, P, K] (module docstring).
    Raises ValueError unless each row's live entries are a prefix, strictly
    increasing, inside [0, v_blk)."""
    p, p2, _ = send.shape
    nb = -(-v_blk // APPLY_GRAN)
    bounds = np.arange(nb + 1, dtype=np.int64) * APPLY_GRAN
    rng = np.empty((p, p2, nb + 1), np.int32)
    for q in range(p):
        for pe in range(p2):
            row = send[q, pe]
            n = int((row >= 0).sum())
            live = row[:n]
            if np.any(live < 0):
                raise ValueError(f"route row ({q}, {pe}): live entries are "
                                 f"not a prefix")
            if n and (np.any(np.diff(live) <= 0) or live[-1] >= v_blk):
                raise ValueError(f"route row ({q}, {pe}) is not strictly "
                                 f"increasing inside [0, {v_blk})")
            rng[q, pe] = np.searchsorted(live, bounds)
    return rng
