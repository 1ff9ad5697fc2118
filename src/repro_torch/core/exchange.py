"""Cross-partition exchange: the port's single-device executor.

Every distributed primitive is written against one contract,

    transpose(x)[p, q, ...] == x[q, p, ...]      for x of shape [P, P, ...],

"partition q's block for partition p arrives at p, labelled q".
`LocalExchange` holds all P partitions on one device, where the exchange is
an axis transpose.  A multi-device executor over `torch.distributed`
(all_to_all) comes with a later slice.

Two more primitives serve the transports (`core/transport.py`):
`ring_transpose`, the same contract as P ring stages (the pipelined ship),
over `ppermute`; and `all_gather_rows`, the broadcast lane's collective.

`ship` moves a buffer through the exchange's wire codec (`core/wire.py`,
set with `with_wire`): encode on the send side, transpose the narrow
payload and its block exponents, decode on the receive side.
"""
from __future__ import annotations

import dataclasses

import torch

from . import transport as transport_mod
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

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Rotate blocks around the partition ring: out[(i + shift) % P]
        gets partition i's block."""
        raise NotImplementedError

    def ring_transpose(self, x: torch.Tensor) -> torch.Tensor:
        """transpose() as P ring stages: stage d moves each partition's
        d-th diagonal block a hop of distance d.  Bit-identical to
        transpose (pure data movement); each stage reads only `x` and
        fills a disjoint part of the result, so a multi-device executor
        can overlap a stage's wire time with work on the blocks that
        already arrived."""
        raise NotImplementedError

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The broadcast lane's collective: every partition contributes
        its block [nl, B, ...] once and receives all of them,
        out[l, q, ...] == x_global[q, ...], shape [nl, P, B, ...]."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Mesh-global sum of a per-executor quantity (local value here)."""
        return x

    def home_rows(self, nl: int, device=None) -> torch.Tensor:
        """[nl] int32 global partition ids of this executor's rows, made
        on `device` (the integrity ladder salts its words with them)."""
        return torch.arange(nl, dtype=torch.int32, device=device)

    @property
    def codec(self) -> WireCodec | None:
        """The wire codec in effect (None: full-width shipping)."""
        return self.wire

    def ship(self, x: torch.Tensor, *, active: torch.Tensor | None = None,
             bound: int | None = None, transport=None) -> torch.Tensor:
        """transpose() through the wire codec and the selected transport.

        active [nl, P, K]: the entries the receiver will read; stale ones
        are zero-substituted before the quantization.  bound: the static
        |value| bound of lossless int narrowing.  transport: a
        `core.transport` plan; a ragged one compacts the active entries,
        so stale positions come back as zeros.  bf16 narrowing stays
        narrow on return; scaled and packed-int payloads decode back to
        their original dtype."""
        tp = transport_mod.ragged_plan(transport, active)
        if tp is not None:
            return transport_mod.ship_transport(self, x, active, bound=bound,
                                                policy=tp)[0]
        enc = wire_mod.encode_leaf(x, self.codec, bound=bound, active=active)
        if enc is None:
            return self.transpose(x)
        payload = self.transpose(enc.payload)
        scale = None if enc.scale is None else self.transpose(enc.scale)
        return wire_mod.decode_leaf(enc.kind, payload, scale, x, self.codec)

    def tree_ship(self, tree, *, active: torch.Tensor | None = None,
                  bound: int | None = None, transport=None):
        tp = transport_mod.ragged_plan(transport, active)
        if tp is not None:
            return transport_mod.ship_transport(self, tree, active,
                                                bound=bound, policy=tp)[0]
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

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        if x.shape[0] != self.p:
            raise ValueError(f"expected [{self.p}, ...], got {tuple(x.shape)}")
        return torch.roll(x, shift % self.p, dims=0)

    def ring_transpose(self, x: torch.Tensor) -> torch.Tensor:
        # stage d: receiver r gets sender (r - d) % p's block x[(r-d) % p, r]
        # and files it at out[r, (r-d) % p]; after p stages out ==
        # transpose(x).  One gather and one scatter copy a stage, indices
        # made on the device (no host-to-device copy: capturable).
        if x.shape[0] != self.p or x.shape[1] != self.p:
            raise ValueError(f"expected [{self.p}, {self.p}, ...], got "
                             f"{tuple(x.shape)}")
        rows = torch.arange(self.p, device=x.device)
        out = torch.empty_like(x)
        for d in range(self.p):
            src = (rows - d) % self.p
            out[rows, src] = x[src, rows]
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        # every partition is resident: each local row l observes each
        # source row q
        if x.shape[0] != self.p:
            raise ValueError(f"expected [{self.p}, ...], got {tuple(x.shape)}")
        return x.unsqueeze(0).expand((self.p,) + tuple(x.shape)).contiguous()


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
