"""End-to-end analytics pipeline (paper §5.2, Fig. 10) on the PyTorch
port: the 20 most important articles of a synthetic Wikipedia by PageRank.

  PYTHONPATH=src python examples/torch_wikipedia_pipeline.py \
      [--articles 2000] [--device cpu]

The stages of examples/wikipedia_pipeline.py through `repro_torch`, all
inside one framework:
  1. parse raw article text -> link graph        (data-parallel)
  2. PageRank on the link graph                  (graph-parallel)
  3. join the top-20 ranks back to their titles  (data-parallel)
It runs on the card unless `--device cpu` asks for the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import Graph, algorithms as alg


def make_wiki(n_articles: int, seed: int = 0) -> list[str]:
    """Synthetic 'XML dump': article i links to Zipf-favoured targets, so a
    few hub articles dominate, the shape of the real link graph."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_articles):
        n_links = int(rng.integers(2, 12))
        targets = rng.zipf(1.5, n_links) % n_articles
        body = ",".join(str(int(t)) for t in targets if int(t) != i)
        lines.append(f"<page><title>Article_{i}</title><links>{body}</links>")
    return lines


def _sync(device):
    if torch.device("cuda" if device is None else device).type == "cuda":
        torch.cuda.synchronize()


def main(device=None, articles: int = 2000, iters: int = 20):
    lines = make_wiki(articles)

    # stage 1: parse
    t0 = time.perf_counter()
    src, dst, titles = [], [], {}
    for line in lines:
        title = line.split("<title>")[1].split("</title>")[0]
        aid = int(title.split("_")[1])
        titles[aid] = title
        links = line.split("<links>")[1].split("</links>")[0]
        for t in links.split(","):
            if t:
                src.append(aid)
                dst.append(int(t))
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    key = src * articles + dst
    _, idx = np.unique(key, return_index=True)
    src, dst = src[idx], dst[idx]
    g = Graph.from_edges(src, dst, num_partitions=8, device=device)
    _sync(device)
    t_parse = time.perf_counter() - t0
    print(f"[stage 1] parsed {len(lines)} articles -> "
          f"{g.s.num_edges} links, {g.s.num_vertices} pages "
          f"({t_parse:.2f}s)")

    # stage 2: PageRank (graph-parallel; join-eliminated 2-way mrTriplets)
    t0 = time.perf_counter()
    res = alg.pagerank(g, num_iters=iters)
    vids, vals = res.graph.vertices_to_numpy()
    t_pr = time.perf_counter() - t0
    print(f"[stage 2] {iters} PageRank iterations ({t_pr:.2f}s)")

    # stage 3: top-20 join with titles (data-parallel view of the result)
    t0 = time.perf_counter()
    order = np.argsort(-vals["pr"])[:20]
    t_join = time.perf_counter() - t0
    print(f"[stage 3] top-k + title join ({t_join:.3f}s)\n")

    print("rank  pagerank   article")
    for r, i in enumerate(order, 1):
        print(f"{r:>4}  {vals['pr'][i]:>8.3f}   {titles[int(vids[i])]}")
    print(f"\nend-to-end: {t_parse + t_pr + t_join:.2f}s "
          f"(parse {t_parse:.2f} / rank {t_pr:.2f} / join {t_join:.3f})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--articles", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(args.device, args.articles, args.iters)
