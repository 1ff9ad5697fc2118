"""How a routed exchange buffer moves (dense transport, f32 wire).

The reference chooses per superstep between a dense all_to_all and a
ragged, compacted one (`repro.core.transport`).  This slice ports the dense
plan and its byte accounting for the f32 wire; the ragged and adaptive
plans come with a later slice and are refused here rather than quietly run
dense.
"""
from __future__ import annotations

import dataclasses

import torch

from .tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TransportPolicy:
    kind: str = "dense"


DENSE = TransportPolicy("dense")


def resolve_transport(spec) -> TransportPolicy:
    """None | "dense" | TransportPolicy("dense") -> the dense policy."""
    if spec is None or spec == "dense" or spec == DENSE:
        return DENSE
    raise NotImplementedError(
        f"transport {spec!r}: only the dense transport is ported")


def _dense_wire_bytes(tree, flags_shipped: bool) -> int:
    """Bytes the dense collectives move on the f32 wire: the payload, plus
    one flag byte per entry when the flags ride a collective (incremental
    ships; full ships rebuild them from the route's structure)."""
    leaves = tree_leaves(tree)
    total = sum(x.numel() * x.element_size() for x in leaves)
    if flags_shipped and leaves:
        nl, p, k = leaves[0].shape[:3]
        total += nl * p * k
    return total


def ship_transport(ex, tree, flags: torch.Tensor, *,
                   policy: TransportPolicy = DENSE,
                   recvflags: torch.Tensor | None = None):
    """Move one routed [nl, P, K, ...] buffer and its [nl, P, K] freshness
    flags; recvflags, when the receiver knows them structurally, skip the
    flags collective.  Returns (recv_tree, recv_flags, bytes shipped)."""
    resolve_transport(policy)
    recv = tree_map(ex.transpose, tree)
    rflags = recvflags if recvflags is not None else ex.transpose(flags)
    return recv, rflags, _dense_wire_bytes(tree, flags_shipped=recvflags is None)
