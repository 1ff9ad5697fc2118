"""Graph coarsening (paper Listing 7) on the PyTorch port: build a DOMAIN
graph from a page graph.

  PYTHONPATH=src python examples/torch_graph_coarsen.py [--device cpu]

The steps of examples/graph_coarsen.py through `repro_torch`: pages live in
domains (vid // 16), all intra-domain links contract (subgraph ->
connected components -> reduceByKey -> rebuild), then PageRank ranks the
domain graph.  It runs on the card unless `--device cpu` asks for the CPU.
"""
import argparse

import numpy as np

from repro_torch.core import Graph, algorithms as alg
from repro_torch.data import rmat, symmetrize


def same_domain(sv, ev, dv):
    return sv["dom"] == dv["dom"]


def main(device=None):
    gd = symmetrize(rmat(9, 6, seed=7))
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    domains = (vids // 16).astype(np.int32)

    g = Graph.from_edges(
        gd.src, gd.dst, vertex_keys=vids,
        vertex_values={"pages": np.ones(gd.num_vertices, np.float32),
                       "dom": domains},
        default_vertex={"pages": np.float32(0), "dom": np.int32(-1)},
        num_partitions=4, device=device)
    print(f"page graph: {g.s.num_vertices} pages, {g.s.num_edges} links")

    coarse = alg.coarsen(g, epred=same_domain, merge="sum")
    print(f"domain graph: {coarse.s.num_vertices} super-vertices, "
          f"{coarse.s.num_edges} inter-domain links")

    cvids, cvals = coarse.vertices_to_numpy()
    print(f"total pages preserved: {int(cvals['pages'].sum())} "
          f"== {gd.num_vertices}")

    res = alg.pagerank(coarse, num_iters=10)
    dv, dvals = res.graph.vertices_to_numpy()
    top = np.argsort(-dvals["pr"])[:5]
    print("top domains by PageRank:")
    for i in top:
        print(f"  domain(super-vertex {int(dv[i])}): "
              f"pr={dvals['pr'][i]:.3f} pages={int(dvals['pages'][i])}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
