"""Graph algorithms composed from the narrow-waist operators (§3.3):
PageRank and connected components, with their host-side oracles."""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import view as view_mod
from .graph import Graph, _degree_msg
from .pregel import PregelResult, pregel

IMAX = 2**31 - 1


def attach_out_degree(g: Graph, kernel_mode: str = "auto") -> Graph:
    """Out-degree as a 0-way-join mrTriplets (§4.5.2), stored as the `deg`
    leaf (at least 1).  Every other leaf's view state survives."""
    vals, exists, g, _ = g.mrTriplets(_degree_msg, "sum", to="src",
                                      kernel_mode=kernel_mode)
    deg = torch.where(exists, vals["deg"], 0.0)
    old = g.vdata if isinstance(g.vdata, dict) else {"v": g.vdata}
    vdata = {**old, "deg": torch.clamp_min(deg, 1.0)}
    view = view_mod.view_after_rewrite(
        g.view, old, vdata, view_mod.keep_through(old, exclude=("deg",)), None)
    return g.replace(vdata=vdata, view=view)


def pagerank_send(sv, ev, dv):
    """Synchronous PageRank message: the source's rank share."""
    return {"m": sv["pr"] / sv["deg"] * ev["w"]}


def delta_pagerank_send(sv, ev, dv):
    """Delta PageRank message: the source's rank change share."""
    return {"m": sv["delta"] / sv["deg"] * ev["w"]}


@functools.lru_cache(maxsize=64)
def pagerank_vprog(reset: float):
    """Synchronous PageRank vprog (one function object per `reset`, so the
    plan and kernel caches hit across calls)."""
    def vprog(vid, v, msg):
        return {**v, "pr": reset + (1.0 - reset) * msg["m"]}
    return vprog


@functools.lru_cache(maxsize=64)
def delta_pagerank_fns(reset: float, tol: float):
    """(vprog, changed_fn) of delta PageRank."""
    def vprog(vid, v, msg):
        new_pr = v["pr"] + (1.0 - reset) * msg["m"]
        return {**v, "pr": new_pr, "delta": new_pr - v["pr"]}

    def changed_fn(old, new):
        return torch.abs(new["pr"] - old["pr"]) > tol
    return vprog, changed_fn


def _pr_init(vid, v):
    return {**v, "pr": torch.tensor(1.0)}


def pagerank(g: Graph, *, num_iters: int = 20, reset: float = 0.15,
             tol: float = 0.0, kernel_mode: str = "auto",
             incremental: bool = True,
             track_metrics: bool = False) -> PregelResult:
    """PageRank via Pregel.  The send UDF reads only source attributes, so
    the dst side of the join is eliminated.

    tol == 0: synchronous PageRank, every vertex recomputes
    reset + (1-reset)*msgSum each superstep.  tol > 0: delta PageRank —
    messages carry rank changes, so skipStale is exact under the sum."""
    g = attach_out_degree(g, kernel_mode)
    zero = {"m": torch.tensor(0.0)}
    if tol <= 0.0:
        return pregel(g.mapV(_pr_init), pagerank_vprog(reset), pagerank_send,
                      "sum", default_msg=zero, max_supersteps=num_iters,
                      skip_stale=None, incremental=incremental,
                      kernel_mode=kernel_mode, track_metrics=track_metrics)
    g = g.mapV(lambda vid, v: {**v, "pr": torch.tensor(reset),
                               "delta": torch.tensor(reset)})
    vprog, changed_fn = delta_pagerank_fns(reset, tol)
    return pregel(g, vprog, delta_pagerank_send, "sum", default_msg=zero,
                  max_supersteps=num_iters, skip_stale="out",
                  incremental=incremental, changed_fn=changed_fn,
                  kernel_mode=kernel_mode, track_metrics=track_metrics)


def pagerank_reference(src: np.ndarray, dst: np.ndarray, n: int,
                       num_iters: int = 20, reset: float = 0.15) -> np.ndarray:
    """Dense numpy float64 oracle (synchronous PR, uniform init 1.0)."""
    pr = np.ones(n, np.float64)
    deg = np.maximum(np.bincount(src, minlength=n), 1)
    for _ in range(num_iters):
        msg = np.bincount(dst, weights=(pr / deg)[src], minlength=n)
        pr = reset + (1 - reset) * msg
    return pr


def cc_send(sv, ev, dv):
    return {"m": sv["cc"]}


def cc_vprog(vid, v, msg):
    return {"cc": torch.minimum(v["cc"], msg["m"])}


def _cc_init(vid, v):
    return {"cc": vid}


def connected_components(g: Graph, *, max_supersteps: int = 100,
                         kernel_mode: str = "auto", incremental: bool = True,
                         track_metrics: bool = False) -> PregelResult:
    """Min-id label diffusion over a symmetrised edge set."""
    return pregel(g.mapV(_cc_init), cc_vprog, cc_send, "min",
                  default_msg={"m": torch.tensor(IMAX, dtype=torch.int32)},
                  max_supersteps=max_supersteps, skip_stale="out",
                  incremental=incremental, kernel_mode=kernel_mode,
                  track_metrics=track_metrics)


def connected_components_reference(src, dst, vids) -> dict[int, int]:
    """Union-find oracle: vertex id -> min id of its component."""
    parent = {int(v): int(v) for v in vids}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, d in zip(src, dst):
        rs, rd = find(int(s)), find(int(d))
        if rs != rd:
            parent[max(rs, rd)] = min(rs, rd)
    return {v: find(int(v)) for v in parent}
