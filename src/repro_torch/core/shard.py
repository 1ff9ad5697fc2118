"""Sharding the engine's state over the ranks of a `torch.distributed`
group: what shard_map's `PS("parts")` specs do to a graph in the reference.

A graph shards along its leading partition axis: rank r of a world of W
holds rows r * nl ... r * nl + nl - 1 (nl = P / W) of every [P, ...]
tensor of the `Graph`, its `Structure`, view, `WireLog` and of a `Col`,
and runs the engine over an `SpmdExchange` (`core/exchange.py`).  Three
facts do not follow that rule:

  * `Structure.agg_pieces[side].multi` holds flat ids q * V + v over all
    partitions (`kernels/segorder.py`): a rank keeps the ids of its own
    rows, re-based to its first row, or the kernels would walk other
    ranks' segments;
  * `Structure.p` stays global (the exchange and the routes are P wide);
  * a `WireLog` counts in row 0 (`core/view.py`): rank 0 takes the totals
    of the global log and every rank adds its own traffic to its local row
    0.  `unshard` folds the ranks' rows back into row 0: the bytes add,
    and the ship count, which counts the collectives a rank joined and so
    grows alike on every rank, is rank 0's (the largest), so a gathered
    log equals the one a `LocalExchange` run keeps.

The host build (`Graph.host`) is a fact of the global layout: a shard
carries none, as the reference's sharded graphs carry none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..kernels.segorder import Pieces
from .collections import Col
from .exchange import Exchange, LocalExchange, SpmdExchange
from .graph import Graph
from .view import WireLog
from .wire import ResidentLeaf


def _walk(x, leaf: Callable, pieces: Callable, graph: Callable,
          wire_log: Callable):
    """Map `leaf` over every tensor of a pytree of engine objects, with the
    rules of the module docstring for piece tables, graphs and wire
    logs."""
    def rec(y):
        if isinstance(y, torch.Tensor):
            return leaf(y)
        if isinstance(y, Exchange):
            return y
        if isinstance(y, Pieces):
            return pieces(y)
        if isinstance(y, WireLog):
            return wire_log(y)
        if isinstance(y, Graph):
            return graph(dataclasses.replace(y, **{
                f.name: rec(getattr(y, f.name))
                for f in dataclasses.fields(y)
                if f.name not in ("ex", "host")}))
        if isinstance(y, ResidentLeaf):
            return ResidentLeaf(rec(y.payload), rec(y.scale), y.kind, y.dtype,
                                y.block)
        if dataclasses.is_dataclass(y) and not isinstance(y, type):
            return dataclasses.replace(y, **{
                f.name: rec(getattr(y, f.name))
                for f in dataclasses.fields(y) if f.init})
        if type(y) is dict:
            return {k: rec(v) for k, v in y.items()}
        if type(y) in (list, tuple):
            return type(y)(rec(v) for v in y)
        return y
    return rec(x)


def _log_fields(log: WireLog) -> tuple:
    return log.ships, log.bytes_shipped, log.bytes_accounted


def shard(tree, rank: int, world: int, *, device=None):
    """Rank `rank`'s rows of every [P, ...] tensor of `tree` (a Graph, Col,
    Structure, GraphView or a pytree of them): copies on `device` when it
    is given, so the rank holds its rows alone and the global tensors can
    go; else views of the global tensors.  The caller installs the rank's
    executor: `shard(g, r, W).replace(ex=SpmdExchange(g.s.p, group))`."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    copies: dict = {}     # one copy a global tensor (agg_perm shares one)

    def rows(t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0]
        if n % world:
            raise ValueError(f"a leading axis of {n} rows does not split "
                             f"over {world} ranks")
        nl = n // world
        out = t[rank * nl:(rank + 1) * nl]
        if device is None:
            return out
        if id(t) not in copies:
            copies[id(t)] = out.to(device, copy=True)
        return copies[id(t)]

    def pieces(pc: Pieces) -> Pieces:
        nl = pc.ptr.shape[0] // world
        v = pc.ptr.shape[1] - 1
        lo, hi = rank * nl * v, (rank + 1) * nl * v
        multi = pc.multi[(pc.multi >= lo) & (pc.multi < hi)] - lo
        return Pieces(rows(pc.ptr), rows(pc.seg),
                      multi if device is None else multi.to(device))

    return _walk(tree, rows, pieces, lambda g: g.replace(host=None),
                 lambda log: WireLog(*map(rows, _log_fields(log))))


def unshard(tree, group=None, *, dst: int | None = None):
    """The global layout of a sharded pytree: every [nl, ...] tensor
    gathered over `group` into [P, ...] in rank order, the piece tables'
    `multi` ids re-based to their rank's rows, wire logs folded into row 0,
    and a Graph's or Col's executor a `LocalExchange` of the same P and
    codec.  A collective: every rank of the group calls it.  With `dst`,
    only group rank `dst` receives the global layout (a gather: no other
    rank holds a copy) and the other ranks return None."""
    world = dist.get_world_size(group)
    here = dst is None or dist.get_rank(group) == dst

    def ex_of(t: torch.Tensor) -> SpmdExchange:
        return SpmdExchange(t.shape[0] * world, group)

    def rows(t: torch.Tensor) -> torch.Tensor:
        # a rank that only sends keeps its own rows in the walk (no copy)
        got = ex_of(t).gather_rows(t.contiguous(), dst)
        return got if here else t

    def pieces(pc: Pieces) -> Pieces:
        nl, v = pc.ptr.shape[0], pc.ptr.shape[1] - 1
        m = pc.multi.to(torch.int64)
        n = torch.tensor([m.numel()], device=m.device)
        width = int(ex_of(n).pmax(n))
        pad = torch.full((1, width), -1, dtype=torch.int64, device=m.device)
        pad[0, :m.numel()] = m
        counts, every = rows(n), rows(pad)               # [world], [world, w]
        ptr, seg = rows(pc.ptr), rows(pc.seg)
        if not here:
            return pc
        multi = torch.cat([every[r, :int(counts[r])] + r * nl * v
                           for r in range(world)]).to(pc.multi.dtype)
        return Pieces(ptr, seg, multi)

    def fold(log: WireLog) -> WireLog:
        def one(t, how):
            got = rows(t)
            if not here:
                return t
            per_rank = got.reshape(world, -1).sum(1)
            out = torch.zeros((world * t.shape[0],), dtype=t.dtype,
                              device=t.device)
            out[0] = per_rank.max() if how == "max" else per_rank.sum()
            return out
        return WireLog(*map(one, _log_fields(log), ("max", "sum", "sum")))

    def graph(g: Graph) -> Graph:
        return g.replace(ex=LocalExchange(g.s.p, wire=g.ex.codec))

    out = _walk(tree, rows, pieces, graph if here else lambda g: g, fold)
    if not here:
        return None
    if isinstance(out, Col):
        out = dataclasses.replace(
            out, ex=LocalExchange(out.keys.shape[0], wire=out.ex.codec))
    return out
