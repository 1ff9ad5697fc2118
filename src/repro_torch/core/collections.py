"""Distributed unordered collections: the data-parallel half of GraphX §3.1.

A `Col` is the static-shape analog of an RDD of key-value pairs:

    keys   [P, N] int32   (a key may repeat; masked-out slots are padding)
    values pytree of [P, N, ...]
    mask   [P, N] bool

`map`, `map_values` and `filter` are purely local (paper §3.2: entirely
data-parallel, no data movement).  The shuffling operators (`shuffle_by_key`,
`reduce_by_key`, `left_join`, `compact`) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .exchange import Exchange, LocalExchange
from .tree import tree_map, vmap2

KEY_PAD = 2**31 - 1


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

    def to_numpy(self):
        """(keys, values) of the live elements, partition-major."""
        m = self.mask.cpu().numpy()
        vals = tree_map(lambda v: v.cpu().numpy()[m], self.values)
        return self.keys.cpu().numpy()[m], vals
