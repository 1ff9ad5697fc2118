"""Quickstart on the PyTorch port: the GraphX data model and operators.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The steps of examples/quickstart.py through `repro_torch`: a small property
graph, the narrow-waist operators (Listing 4 of the paper), then PageRank,
connected components and a triangle count.  It runs on the card unless
`--device cpu` asks for the CPU, where the kernels' plain versions run.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Graph, algorithms as alg
from repro_torch.data import rmat, symmetrize


def more_senior(sv, ev, dv):
    return {"n": torch.where(sv["age"] > dv["age"], 1.0, 0.0)}


def main(device=None):
    # --- a social-network-shaped graph (power-law, 1k vertices) -----------
    gd = rmat(10, 8, seed=42)
    print(f"graph: {gd.num_vertices} vertices, {gd.num_edges} edges")

    vids = np.arange(gd.num_vertices, dtype=np.int64)
    g = Graph.from_edges(
        gd.src, gd.dst,
        vertex_keys=vids,
        vertex_values={"age": (20 + vids % 50).astype(np.float32)},
        default_vertex={"age": np.float32(0)},
        num_partitions=4, device=device)

    # --- collection view + data-parallel ops (Listing 3) -------------------
    vertices = g.vertices()
    n_over_40 = vertices.filter(lambda k, v: v["age"] > 40).count()
    print(f"vertices over 40: {int(n_over_40)}")

    # --- triplets + mrTriplets (Fig. 2 of the paper: senior neighbours) ----
    seniors, exists, _, metrics = g.mrTriplets(more_senior, "sum")
    print(f"mrTriplets join arity after elimination: {metrics['join_arity']} "
          f"(UDF reads both endpoints -> 3-way)")

    # --- subgraph: restrict to the under-40 community ----------------------
    young = g.subgraph(vpred=lambda vid, v: v["age"] <= 40)
    print(f"subgraph shares structure with parent: {young.s is g.s}")

    # --- graph algorithms from the algorithm library -----------------------
    pr = alg.pagerank(g, num_iters=15)
    ids, vals = pr.graph.vertices_to_numpy()
    top = ids[np.argsort(-vals['pr'])[:5]]
    print(f"top-5 by PageRank: {top.tolist()}")

    sgd = symmetrize(gd)
    sg = Graph.from_edges(sgd.src, sgd.dst, num_partitions=4, device=device)
    cc = alg.connected_components(sg)
    _, ccv = cc.graph.vertices_to_numpy()
    print(f"connected components: {len(set(ccv['cc'].tolist()))} "
          f"(in {cc.supersteps} supersteps)")

    _, tri, _ = alg.triangle_count(sg, n_ids=gd.num_vertices)
    print(f"triangles: {int(round(float(tri)))}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
