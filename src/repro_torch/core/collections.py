"""Distributed unordered collections: the data-parallel half of GraphX §3.1.

A `Col` is the static-shape analog of an RDD of key-value pairs:

    keys   [P, N] int32   (a key may repeat; masked-out slots are padding)
    values pytree of [P, N, ...]
    mask   [P, N] bool

`map`, `map_values` and `filter` are purely local (paper §3.2: entirely
data-parallel, no data movement).  `reduce_by_key` and `left_join` shuffle
with the same Exchange the graph engine uses, so a pipeline mixing
collection and graph operators runs on one substrate.

Shuffles have a static capacity per destination partition; `shuffle_by_key`
returns an overflow count (a 0-d device tensor) that callers must check, as
`compact` returns the entries it dropped.  Every operator is a handful of
sorts, gathers and scatters on the collection's device, with no host read
inside: outputs equal the reference's byte for byte, padding included, and
the segmented reduce follows `jax.lax.associative_scan`'s combine order, so
f32 sums are bit-equal too (and deterministic on the card: no atomics).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .exchange import Exchange, LocalExchange
from .hashing import hash_mod_t
from .tree import bmask, tree_map, vmap2

KEY_PAD = 2**31 - 1

_REDUCE_FNS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
               "mul": torch.mul}


def _take(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1: leaf [P, N, ...], idx [P, M] -> [P, M, ...]."""
    return torch.take_along_dim(leaf, bmask(idx, leaf).long(), dim=1)


def _seg_reduce_sorted(vals: torch.Tensor, starts: torch.Tensor,
                       op: str | Callable, dim: int = 0) -> torch.Tensor:
    """Segmented inclusive scan along `dim` over sorted runs: starts[i]
    begins a segment, and the last element of each run carries its total.

    `jax.lax.associative_scan`'s recursion, step for step: combine the
    pairs (0,1), (2,3), ...; scan those; combine each odd result with the
    next even input and prepend element 0; interleave.  The combine is
    where(fb, vb, fn(va, vb)), so sums, min, max, mul and a callable give
    the reference's bits.  `starts` has vals' shape up to `dim`."""
    fn = _REDUCE_FNS[op] if isinstance(op, str) else op
    lead = (slice(None),) * dim

    def cut(x, start, stop=None, step=1):
        return x[lead + (slice(start, stop, step),)]

    def combine(a, b):
        (fa, va), (fb, vb) = a, b
        return fa | fb, torch.where(bmask(fb, vb), vb, fn(va, vb))

    def interleave(even, odd):
        shape = list(even.shape)
        shape[dim] += odd.shape[dim]
        out = even.new_empty(shape)
        out[lead + (slice(0, None, 2),)] = even
        out[lead + (slice(1, None, 2),)] = odd
        return out

    def scan(f, v):
        n = v.shape[dim]
        if n < 2:
            return f, v
        of, ov = scan(*combine((cut(f, 0, -1, 2), cut(v, 0, -1, 2)),
                               (cut(f, 1, None, 2), cut(v, 1, None, 2))))
        stop = -1 if n % 2 == 0 else None
        ef, ev = combine((cut(of, 0, stop), cut(ov, 0, stop)),
                         (cut(f, 2, None, 2), cut(v, 2, None, 2)))
        ef = torch.cat([cut(f, 0, 1), ef], dim)
        ev = torch.cat([cut(v, 0, 1), ev], dim)
        return interleave(ef, of), interleave(ev, ov)

    return scan(starts, vals)[1]


def shuffle_by_key(keys: torch.Tensor, values: Any, mask: torch.Tensor,
                   ex: Exchange, capacity: int, salt: int = 0):
    """Route each live (k, v) to partition hash(k) % P.  Returns (keys',
    values', mask', overflow): [nl, P * capacity] buffers, source-major, in
    each source's stable key-hash order; dead slots hold KEY_PAD and zeros;
    overflow (int32, on the device) counts the entries past `capacity`, over
    the whole group under a multi-process executor (`ex.psum`), so every
    rank that checks it decides alike."""
    p = ex.p
    nl, n = keys.shape
    dest = torch.where(mask, hash_mod_t(keys, p, salt), p)   # padding -> p
    dest_sorted, order = torch.sort(dest, dim=1, stable=True)
    first = torch.searchsorted(dest_sorted, dest_sorted, right=False)
    pos = torch.arange(n, device=keys.device) - first
    real = dest_sorted < p
    overflow = ex.psum(((pos >= capacity) & real).sum(dtype=torch.int32))
    fits = pos < capacity
    # entries past capacity and padding land in row p, which is cut off
    row = torch.where(real & fits, dest_sorted, p).long()
    col = torch.where(fits, pos, 0)
    part = torch.arange(nl, device=keys.device)[:, None]

    def scatter_leaf(leaf_sorted, fill):
        buf = leaf_sorted.new_full((nl, p + 1, capacity)
                                   + tuple(leaf_sorted.shape[2:]), fill)
        buf[part, row, col] = leaf_sorted
        return buf[:, :p]

    kbuf = scatter_leaf(_take(keys, order), KEY_PAD)
    vbuf = tree_map(lambda v: scatter_leaf(_take(v, order), 0), values)
    mbuf = scatter_leaf(_take(mask, order) & real, False)

    kr = ex.transpose(kbuf).reshape(nl, p * capacity)
    vr = tree_map(lambda v: ex.ship(v).reshape(
        (nl, p * capacity) + tuple(v.shape[3:])), vbuf)
    mr = ex.transpose(mbuf).reshape(nl, p * capacity)
    kr = torch.where(mr, kr, KEY_PAD)
    return kr, vr, mr, overflow


def _sort_live(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row stable order of the live keys, padding last."""
    return torch.sort(torch.where(mask, keys, KEY_PAD), dim=1,
                      stable=True)[1]


def merge_probe(keys: torch.Tensor, values: Any, mask: torch.Tensor,
                query: torch.Tensor):
    """The merge join's probe (§4.3): sort (keys, values) per row by live
    key, binary-search each query key of the same row.  Returns (the values
    at the probe, found [P, M]); where nothing matches, the values are
    whatever the clipped probe reads, as in the reference."""
    order = _sort_live(keys, mask)
    ks = _take(keys, order)
    idx = torch.searchsorted(ks, query.contiguous()).clamp_(0, ks.shape[1] - 1)
    at = _take(order, idx)
    return (tree_map(lambda leaf: _take(leaf, at), values),
            _take(ks, idx) == query)


@dataclasses.dataclass(frozen=True, eq=False)
class Col:
    """Distributed key-value collection (see module docstring)."""

    keys: torch.Tensor
    values: Any
    mask: torch.Tensor
    ex: Exchange = None

    @staticmethod
    def from_numpy(keys, values, p: int, ex: Exchange | None = None,
                   pad_multiple: int = 8, device=None) -> "Col":
        """Round-robin ingest of host data (the paper's raw-file load):
        element i lands in partition i % p, row i // p; rows pad to a
        multiple of `pad_multiple` with KEY_PAD keys, masked out."""
        from .graph import resolve_device, _to_device
        dev = resolve_device(device)
        keys = np.asarray(keys)
        n = keys.shape[0]
        per = -(-max(n, 1) // p)
        per = -(-per // pad_multiple) * pad_multiple
        kbuf = np.full((p, per), KEY_PAD, np.int32)
        mbuf = np.zeros((p, per), bool)
        idx = np.arange(n)
        part, row = idx % p, idx // p
        kbuf[part, row] = keys
        mbuf[part, row] = True

        def place(leaf):
            leaf = np.asarray(leaf)
            buf = np.zeros((p, per) + leaf.shape[1:], leaf.dtype)
            buf[part, row] = leaf
            return _to_device(buf, dev)

        return Col(_to_device(kbuf, dev), tree_map(place, values),
                   _to_device(mbuf, dev), ex or LocalExchange(p))

    @property
    def p(self) -> int:
        return self.keys.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum()

    def map_values(self, f: Callable) -> "Col":
        """f(v) -> v2 per element."""
        return Col(self.keys, vmap2(f)(self.values), self.mask, self.ex)

    def map(self, f: Callable) -> "Col":
        """f(k, v) -> (k2, v2) per element; no data moves."""
        k2, v2 = vmap2(f)(self.keys, self.values)
        return Col(k2, v2, self.mask, self.ex)

    def filter(self, pred: Callable) -> "Col":
        """Keep the elements where pred(k, v) holds (a mask, no compaction)."""
        keep = vmap2(pred)(self.keys, self.values)
        return Col(self.keys, self.values, self.mask & keep, self.ex)

    def reduce_by_key(self, op: str | Callable = "sum",
                      capacity: int | None = None) -> tuple["Col", torch.Tensor]:
        """(the collection reduced per key and partitioned by key hash, the
        shuffle's overflow).  op: "sum", "min", "max", "mul" or an
        associative callable on tensors."""
        capacity = capacity or 2 * self.keys.shape[1]
        k, v, m, ovf = shuffle_by_key(self.keys, self.values, self.mask,
                                      self.ex, capacity)
        order = _sort_live(k, m)
        ks, ms = _take(k, order), _take(m, order)
        edge = ks[:, 1:] != ks[:, :-1]
        one = torch.ones_like(ms[:, :1])
        starts = torch.cat([one, edge], 1)
        lasts = torch.cat([edge, one], 1)
        vred = tree_map(lambda leaf: _seg_reduce_sorted(
            _take(leaf, order), starts, op, dim=1), v)
        return Col(ks, vred, ms & lasts, self.ex), ovf

    def left_join(self, other: "Col", capacity: int | None = None):
        """Left outer equi-join by key, both sides shuffled to the key's
        home.  Returns (a collection of (v_left, v_right, found), the two
        shuffles' overflow)."""
        capacity = capacity or 2 * max(self.keys.shape[1],
                                       other.keys.shape[1])
        kl, vl, ml, o1 = shuffle_by_key(self.keys, self.values, self.mask,
                                        self.ex, capacity)
        kr, vr, mr, o2 = shuffle_by_key(other.keys, other.values, other.mask,
                                        self.ex, capacity)
        vprobe, hit = merge_probe(kr, vr, mr, kl)
        return Col(kl, (vl, vprobe, hit & ml), ml, self.ex), o1 + o2

    def compact(self, width: int) -> tuple["Col", torch.Tensor]:
        """Coalesce each partition to `width` columns, live entries first in
        key order (shuffle outputs are P * capacity wide).  Returns (col,
        the live entries that did not fit, int32 on the device)."""
        order = _sort_live(self.keys, self.mask)[:, :width]
        ms = _take(self.mask, order)
        vs = tree_map(lambda leaf: _take(leaf, order), self.values)
        dropped = (self.mask.sum(dtype=torch.int32)
                   - ms.sum(dtype=torch.int32))
        return Col(_take(self.keys, order), vs, ms, self.ex), dropped

    def to_numpy(self):
        """(keys, values) of the live elements, partition-major."""
        m = self.mask.cpu().numpy()
        vals = tree_map(lambda v: v.cpu().numpy()[m], self.values)
        return self.keys.cpu().numpy()[m], vals
