"""How a routed exchange buffer moves (the dense transport).

The reference chooses per superstep between a dense all_to_all and a
ragged, compacted one (`repro.core.transport`).  The port has the dense
plan, through the exchange's wire codec (`core/wire.py`), and its byte
accounting; the ragged and adaptive plans, the capacity tiers, the ring
pipeline and the integrity ladder come with a later slice and are refused
here rather than quietly run dense.
"""
from __future__ import annotations

import dataclasses

import torch

from . import wire as wire_mod
from .tree import tree_leaves


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


def _dense_wire_bytes(tree, codec, bound, flags_shipped: bool) -> int:
    """Bytes the dense collectives move: the codec's payload and block
    exponents, plus one flag byte per entry when the flags ride a
    collective (incremental ships; full ships rebuild them from the
    route's structure)."""
    leaves = tree_leaves(tree)
    total = wire_mod.static_wire_bytes(tree, codec, bound)
    if flags_shipped and leaves:
        nl, p, k = leaves[0].shape[:3]
        total += nl * p * k
    return total


def ship_transport(ex, tree, flags: torch.Tensor, *, bound: int | None = None,
                   policy: TransportPolicy = DENSE,
                   recvflags: torch.Tensor | None = None):
    """Move one routed [nl, P, K, ...] buffer and its [nl, P, K] freshness
    flags through the exchange's codec (flags are the wire's active set:
    stale entries ship as zeros); recvflags, when the receiver knows them
    structurally, skip the flags collective.  Returns (recv_tree,
    recv_flags, bytes shipped)."""
    resolve_transport(policy)
    recv = ex.tree_ship(tree, active=flags, bound=bound)
    rflags = recvflags if recvflags is not None else ex.transpose(flags)
    return recv, rflags, _dense_wire_bytes(tree, ex.codec, bound,
                                           flags_shipped=recvflags is None)
