"""Cross-partition exchange: the executors of the port.

Every distributed primitive is written against one contract,

    transpose(x)[p, q, ...] == x[q, p, ...]      for x of shape [P, P, ...],

"partition q's block for partition p arrives at p, labelled q".  Two
executors keep it:

  * `LocalExchange` holds all P partitions on one device, where the
    exchange is an axis transpose;
  * `SpmdExchange` runs one process a rank of a `torch.distributed` group
    (the reference's shard_map over a "parts" mesh axis): each rank holds
    nl = P / world consecutive partitions as the local block [nl, P, ...],
    and the exchange is one `all_to_all_single`.  At world 1 it holds
    every partition and equals `LocalExchange` primitive by primitive.

Two more primitives serve the transports (`core/transport.py`):
`ring_transpose`, the same contract as ring stages (the pipelined ship),
over `ppermute`; and `all_gather_rows`, the broadcast lane's collective.
`psum` / `pmax` reduce a per-executor figure over the group, so every plan
decision the ranks make from it is the same on each (mismatched
collectives would hang), and `home_rows` names a rank's global rows.

`ship` moves a buffer through the exchange's wire codec (`core/wire.py`,
set with `with_wire`): encode on the send side, transpose the narrow
payload and its block exponents, decode on the receive side.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

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

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Mesh-global maximum of a per-executor quantity (an occupancy
        the host plans a capacity from; local value here)."""
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


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as flat uint8 (every dtype, bool and the narrow
    floats included, moves through one collective type)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).reshape(shape)


@dataclasses.dataclass(frozen=True)
class SpmdExchange(Exchange):
    """Multi-process executor over a `torch.distributed` group (None: the
    default group).  Rank r holds the nl = P / world consecutive partitions
    r * nl ... r * nl + nl - 1 as the leading axis of every [nl, ...]
    tensor (`core.shard.shard` cuts a graph so); a world that does not
    divide P is refused.

    The collectives move each tensor's bytes (uint8), so bool masks, bf16
    and fp8 payloads travel as they are.  On a gloo group every collective
    stages through host tensors by design, one copy down and one up (gloo's
    support for CUDA tensors differs from collective to collective); on
    CPU tensors, and on an NCCL group, the staging is a no-op."""

    p: int
    group: Any = None
    wire: WireCodec | None = None

    def __post_init__(self):
        world = dist.get_world_size(self.group)
        if self.p % world:
            raise ValueError(f"a world of {world} ranks does not divide "
                             f"P={self.p} partitions")
        # cached facts of the group (frozen: set through object)
        object.__setattr__(self, "world", world)
        object.__setattr__(self, "rank", dist.get_rank(self.group))
        object.__setattr__(self, "nl", self.p // world)
        object.__setattr__(self, "host_staged",
                           dist.get_backend(self.group) == "gloo")

    # --------------------------------------------------------- staging
    def _down(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective reads: on the host under gloo."""
        return t.cpu() if self.host_staged else t

    def _check(self, x: torch.Tensor, square: bool) -> None:
        want = (self.nl, self.p) if square else (self.nl,)
        if tuple(x.shape[:len(want)]) != want:
            raise ValueError(f"rank {self.rank}: expected a local block "
                             f"{want + ('...',)}, got {tuple(x.shape)}")

    # ----------------------------------------------------- collectives
    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, square=True)
        w, nl, rest = self.world, self.nl, tuple(x.shape[2:])
        # destination-major tiles: send[d, i, j] = x[i, d * nl + j], the
        # block of my row i for partition d * nl + j
        send = x.reshape((nl, w, nl) + rest).transpose(0, 1)
        buf = self._down(_as_bytes(send))
        got = torch.empty_like(buf)
        dist.all_to_all_single(got, buf, group=self.group)
        # recv[s, i, j] = x_global[s * nl + i, rank * nl + j]; the local
        # permute files it at out[j, s * nl + i] (at world 1, recv is x
        # itself and this permute IS the transpose)
        recv = _from_bytes(got.to(x.device), x.dtype, (w, nl, nl) + rest)
        perm = (2, 0, 1) + tuple(range(3, 3 + len(rest)))
        return recv.permute(perm).reshape((nl, self.p) + rest).contiguous()

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        # global row g = rank * nl + l goes to row (g + shift) % P: with
        # shift % P = a * nl + b, my first nl - b rows land on rank + a at
        # rows b.., the last b on rank + a + 1 at rows ..b
        self._check(x, square=False)
        nl, w, r = self.nl, self.world, self.rank
        a, b = divmod(shift % self.p, nl)
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        moves = [(x[:nl - b], a, slice(b, nl))]
        if b:
            moves.append((x[nl - b:], a + 1, slice(0, b)))
        ops, landed = [], []
        for blk, hop, rows in moves:
            if hop % w == 0:
                out[rows] = blk
                continue
            send = self._down(_as_bytes(blk))
            recv = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, (r + hop) % w, self.group),
                    dist.P2POp(dist.irecv, recv, (r - hop) % w, self.group)]
            landed.append((recv, rows, tuple(blk.shape)))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for recv, rows, shape in landed:
            out[rows] = _from_bytes(recv.to(x.device), x.dtype, shape)
        return out

    def ring_transpose(self, x: torch.Tensor) -> torch.Tensor:
        # stage d: my column tile for rank (r + d) goes a hop of d ranks
        # (a ppermute by d * nl rows); the tile arriving came from rank
        # (r - d) and fills that rank's columns, transposed.  Stage 0 is
        # the diagonal, no collective.  Each stage reads only x and fills
        # a disjoint slice of the result.
        self._check(x, square=True)
        nl, w, r = self.nl, self.world, self.rank
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        for d in range(w):
            col = (r + d) % w
            tile = x[:, col * nl:(col + 1) * nl]
            if d:
                tile = self.ppermute(tile, d * nl)
            src = (r - d) % w
            out[:, src * nl:(src + 1) * nl] = tile.transpose(0, 1)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        rows = self.gather_rows(x)
        return rows.unsqueeze(0).expand((self.nl,) + tuple(rows.shape)) \
            .contiguous()

    def gather_rows(self, x: torch.Tensor,
                    dst: int | None = None) -> torch.Tensor | None:
        """The ranks' [nl, ...] rows stacked in rank order into the global
        [P, ...]: on every rank (`dst` None, `all_gather_into_tensor`), or
        on group rank `dst` alone (`gather`; the other ranks get None)."""
        self._check(x, square=False)
        buf = self._down(_as_bytes(x))
        if dst is None:
            got = buf.new_empty((self.world * buf.numel(),))
            dist.all_gather_into_tensor(got, buf, group=self.group)
        else:
            parts = ([torch.empty_like(buf) for _ in range(self.world)]
                     if self.rank == dst else None)
            dist.gather(buf, parts, group=self.group,
                        dst=dist.get_global_rank(self.group or
                                                 dist.group.WORLD, dst))
            if parts is None:
                return None
            got = torch.cat(parts)
        return _from_bytes(got.to(x.device), x.dtype,
                           (self.p,) + tuple(x.shape[1:]))

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.detach().to("cpu" if self.host_staged else x.device,
                          copy=True)
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def home_rows(self, nl: int, device=None) -> torch.Tensor:
        return self.rank * nl + torch.arange(nl, dtype=torch.int32,
                                             device=device)


def spmd_of(ex) -> SpmdExchange | None:
    """The multi-process executor under `ex` (a fault injector's inner
    one), or None."""
    ex = getattr(ex, "inner", ex)
    return ex if isinstance(ex, SpmdExchange) else None


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
