"""Cross-partition exchange: the port's single-device executor.

Every distributed primitive is written against one contract,

    transpose(x)[p, q, ...] == x[q, p, ...]      for x of shape [P, P, ...],

"partition q's block for partition p arrives at p, labelled q".
`LocalExchange` holds all P partitions on one device, where the exchange is
an axis transpose.  A multi-device executor over `torch.distributed`
(all_to_all) comes with a later slice.

`ship` moves a buffer through the exchange's wire codec (`core/wire.py`,
set with `with_wire`): encode on the send side, transpose the narrow
payload and its block exponents, decode on the receive side.
"""
from __future__ import annotations

import dataclasses

import torch

from . import wire as wire_mod
from .tree import tree_map
from .wire import WireCodec, make_codec


class Exchange:
    """Executor interface.  `p` is the number of graph partitions."""

    p: int
    # the codec every `ship` goes through (None: full width)
    wire: WireCodec | None = None

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Mesh-global sum of a per-executor quantity (local value here)."""
        return x

    def home_rows(self, nl: int) -> torch.Tensor:
        """[nl] int32 global partition ids of this executor's rows."""
        return torch.arange(nl, dtype=torch.int32)

    @property
    def codec(self) -> WireCodec | None:
        """The wire codec in effect (None: full-width shipping)."""
        return self.wire

    def ship(self, x: torch.Tensor, *, active: torch.Tensor | None = None,
             bound: int | None = None) -> torch.Tensor:
        """transpose() through the wire codec (the dense transport).

        active [nl, P, K]: the entries the receiver will read; stale ones
        are zero-substituted before the quantization.  bound: the static
        |value| bound of lossless int narrowing.  bf16 narrowing stays
        narrow on return; scaled and packed-int payloads decode back to
        their original dtype."""
        enc = wire_mod.encode_leaf(x, self.codec, bound=bound, active=active)
        if enc is None:
            return self.transpose(x)
        payload = self.transpose(enc.payload)
        scale = None if enc.scale is None else self.transpose(enc.scale)
        return wire_mod.decode_leaf(enc.kind, payload, scale, x, self.codec)

    def tree_ship(self, tree, *, active: torch.Tensor | None = None,
                  bound: int | None = None):
        return tree_map(lambda x: self.ship(x, active=active, bound=bound),
                        tree)


@dataclasses.dataclass(frozen=True)
class LocalExchange(Exchange):
    """Single-device executor: the exchange transposes the block matrix."""

    p: int
    wire: WireCodec | None = None

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.p or x.shape[1] != self.p:
            raise ValueError(f"expected [{self.p}, {self.p}, ...], got "
                             f"{tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()


def with_wire(ex: Exchange, codec, *, delta: bool | None = None,
              block: int | None = None, pack_ints: bool | None = None,
              resident: bool | None = None) -> Exchange:
    """A copy of `ex` shipping through the given wire codec: a WireCodec, a
    name of `wire.CODEC_NAMES`, or None to strip the codec; the keywords
    override the resolved codec's fields (`resident=True` keeps eligible
    mirrors encoded in device memory, DESIGN.md §2.4)."""
    resolved = make_codec(codec, delta=delta, block=block,
                          pack_ints=pack_ints, resident=resident)
    return dataclasses.replace(ex, wire=resolved)
