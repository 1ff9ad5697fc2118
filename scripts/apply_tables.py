"""Size and host build time of the fused apply's route table.

    python3 scripts/apply_tables.py [--scale 22] [--partitions 4]

Builds the structure of rmat(scale, 16, seed=0) on the host
(`partition.build_structure`) and, for both route sides, the table the
apply kernel reads (`applyroute.route_ranges`, apply_rng [P, P, NB+1])
beside the dense inverse table it replaced (apply_inv [P, V_blk, P],
inverse_table below): bytes, host seconds (best of 3), and the index
words each holds against the route's live entries.  Host only; no card.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def inverse_table(send: np.ndarray, v_blk: int) -> np.ndarray:
    """The replaced table: inv[q, v, pe] = j where send[q, pe, j] == v,
    else -1."""
    p = send.shape[0]
    inv = np.full((p, v_blk, p), -1, np.int32)
    q, pe, j = np.nonzero(send >= 0)
    inv[q, send[q, pe, j], pe] = j
    return inv


def best_seconds(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--partitions", type=int, default=4)
    args = ap.parse_args()
    from repro_torch.core import partition
    from repro_torch.data import rmat
    from repro_torch.kernels import applyroute

    gd = rmat(args.scale, 16, seed=0)
    t0 = time.perf_counter()
    s = partition.build_structure(gd.src, gd.dst, args.partitions)
    print(f"rmat({args.scale},16), P={args.partitions}: structure built in "
          f"{time.perf_counter() - t0:.2f} s; V_blk {s.v_blk}, K "
          f"{s.k_route}, APPLY_GRAN {applyroute.APPLY_GRAN}")
    for side in ("dst", "src"):
        send = s.routes[side][0]
        live = int((send >= 0).sum())
        slots = int(s.home_mask.sum())
        t_inv = best_seconds(lambda: inverse_table(send, s.v_blk))
        t_rng = best_seconds(lambda: applyroute.route_ranges(send, s.v_blk))
        inv = inverse_table(send, s.v_blk)
        rng = applyroute.route_ranges(send, s.v_blk)
        print(f"  {side}: {live} live route entries ({live / slots:.3f} a "
              f"home vertex), route {send.nbytes} B; apply_inv {inv.nbytes} B"
              f" ({inv.nbytes / (4 * live):.2f}x the live entries' words), "
              f"built in {t_inv:.3f} s; apply_rng {rng.nbytes} B "
              f"({rng.nbytes / inv.nbytes:.4f}x apply_inv), built in "
              f"{t_rng:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
