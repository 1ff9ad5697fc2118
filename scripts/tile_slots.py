"""Slots per live edge of the reference's Pallas tile tables.

    PYTHONPATH=src python scripts/tile_slots.py 12 14 16

For rmat(scale, 16, seed=0) partitioned 2D over P=4, builds the reference
structure (`repro.core.partition.build_structure`, which builds the
`tiles` tables the Pallas triplet kernel needs) and prints, per
aggregation side, the slots of the chunk tables (`perm.size`) over the live
edges, next to the port's CSR row pointers (`agg_ptr`, one int32 per mirror
slot plus one per partition).  Host-side counting only; no device runs.
"""
import sys

from repro.core.partition import build_structure
from repro.data import rmat


def main(scales):
    for scale in scales:
        gd = rmat(scale, 16, seed=0)
        s = build_structure(gd.src, gd.dst, 4)
        live = int(s.edge_mask.sum())
        for side in ("dst", "src"):
            slots = s.tiles[side]["perm"].size
            print(f"rmat({scale},16) P=4 {side}: live edges {live}, tile "
                  f"slots {slots} ({slots / live:.2f} per edge, "
                  f"{slots * 4 / 2**20:.1f} MiB of int32 perm); CSR pointers "
                  f"{s.num_partitions * (s.v_mir + 1)} "
                  f"({s.num_partitions * (s.v_mir + 1) * 4 / 2**20:.2f} MiB)")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [12, 14, 16])
