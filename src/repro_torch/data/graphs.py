"""Synthetic power-law graphs (numpy), identical to `repro.data.graphs`.

R-MAT with (a,b,c,d)=(.57,.19,.19,.05) reproduces the skewed degree
distributions of the paper's LiveJournal/Wikipedia/Twitter crawls (Table 1).
Generation is seeded, so the port and the reference build the same graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphData:
    src: np.ndarray
    dst: np.ndarray
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def rmat(scale: int, edge_factor: int = 16, *, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         dedupe: bool = True) -> GraphData:
    """R-MAT power-law digraph with 2**scale vertices."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities (a | b / c | d)
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= (go_down.astype(np.int64) << bit)
        dst |= (go_right.astype(np.int64) << bit)
    if dedupe:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    keep = src != dst          # drop self loops
    return GraphData(src[keep], dst[keep], n)


def symmetrize(g: GraphData) -> GraphData:
    """Add reverse edges (CC benchmarks run on the symmetrised graph)."""
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    key = src * g.num_vertices + dst
    _, idx = np.unique(key, return_index=True)
    return GraphData(src[idx], dst[idx], g.num_vertices)


def chain(n: int) -> GraphData:
    """Path graph — worst case for label-diffusion supersteps."""
    v = np.arange(n - 1, dtype=np.int64)
    return GraphData(v, v + 1, n)


def star(n: int) -> GraphData:
    """One high-degree hub — the vertex-cut stress case."""
    return GraphData(np.zeros(n - 1, np.int64),
                     np.arange(1, n, dtype=np.int64), n)


# paper Table 1 at reduced scale (name: (scale, edge_factor))
TABLE1_SCALED = {
    "livejournal-sim": (12, 8),
    "wikipedia-sim": (12, 10),
    "twitter-sim": (13, 16),
}


def table1(name: str, seed: int = 0) -> GraphData:
    scale, ef = TABLE1_SCALED[name]
    return rmat(scale, ef, seed=seed)
