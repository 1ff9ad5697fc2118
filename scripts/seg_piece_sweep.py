"""Sweep the piece length of the segment order (SEG_PIECE) on the card.

    python3 scripts/seg_piece_sweep.py

Builds rmat(22, 16, seed=0) with P=4 on the card (chip_smoke.py's PageRank
graph) and, for each piece length T in 32, 64, 128, rebuilds the kernels
with `#define SEG_PIECE T` and the dst piece tables with T, then holds the
triplet kernel at the PageRank send and segment_sum on the unfused
PageRank aggregate against `ref.ordered_segment_reduce` (bit for bit) and
times both with CUDA events.  The constant in `csrc/segorder.cuh` and
`kernels/segorder.py` is the T this chose.  Needs one CUDA card.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PIECES = (32, 64, 128)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("seg_piece_sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms
    from repro_torch.core import algorithms as alg
    from repro_torch.core import mrtriplets as mt
    from repro_torch.core.graph import Graph
    from repro_torch.data import rmat
    from repro_torch.kernels import build, ref, segorder
    from repro_torch.kernels import segment_sum as seg_mod
    from repro_torch.kernels import triplet as tri_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gd = rmat(22, 16, seed=0)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device=dev)
    s = g.s
    gen = torch.Generator().manual_seed(0)
    S = s.p * s.v_mir
    x = torch.cat([torch.rand((S, 1), generator=gen) * 50 + 1,
                   torch.rand((S, 1), generator=gen)], 1).to(dev)
    ev = g.edata["w"].reshape(-1, 1).contiguous()
    live = g.emask.contiguous()
    msgs = torch.rand((s.p, s.e_blk, 1), generator=gen).to(dev)
    spec = mt.fused_plan(alg.attach_out_degree(g).mapV(alg._pr_init),
                         alg.pagerank_send, "sum").kernel
    ptr = s.agg_ptr["dst"]
    ptr_np = ptr.cpu().numpy()
    template, default = build.template, segorder.SEG_PIECE
    for t in PIECES:
        segorder.SEG_PIECE = t
        build.template = lambda name, t=t: template(name).replace(
            f"#define SEG_PIECE {default}", f"#define SEG_PIECE {t}")
        tri_mod.source.cache_clear()
        seg_mod.source.cache_clear()
        t0 = time.perf_counter()
        pieces = segorder.Pieces(*(torch.from_numpy(a).to(dev) for a in
                                   segorder.piece_tables(ptr_np)))
        t_tab = time.perf_counter() - t0
        tri = lambda: tri_mod.fused_triplet(  # noqa: E731
            x, ev, s.src_slot, s.dst_slot, live, ptr, None, spec,
            pieces=pieces)
        seg = lambda: seg_mod.segment_sum(msgs, live, ptr, pieces)  # noqa: E731
        out, cnt = tri()
        got = seg()
        want, wcnt = ref.ordered_triplet(x, ev, s.src_slot, s.dst_slot, live,
                                         ptr, None, spec, pieces)
        wseg, _ = ref.ordered_segment_reduce(msgs, live, ptr, pieces)
        torch.cuda.synchronize()
        ok = (torch.equal(out, want) and torch.equal(cnt, wcnt)
              and torch.equal(got.reshape(-1, 1), wseg))
        print(f"SEG_PIECE {t}: pieces {int(pieces.ptr[:, -1].sum())}, "
              f"multi-piece segments {pieces.multi.shape[0]}, tables "
              f"{t_tab:.2f} s; triplet (pagerank send) "
              f"{cuda_ms(tri, 20):.4f} ms, segment_sum {cuda_ms(seg, 20):.4f}"
              f" ms; kernels == ordered model: {ok}", flush=True)
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
