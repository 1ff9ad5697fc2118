"""Pytree helpers shared across the engine (torch.utils._pytree).

Dicts flatten in sorted key order, as `jax.tree` flattens them (torch's
pytree keeps insertion order): a vprog that builds its output dict in
another key order than the state has the same structure, the same leaf
order and the same plan as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

tree_unflatten = pytree.tree_unflatten


def canonical(tree: Any) -> Any:
    """`tree` with the keys of every (nested) plain dict in sorted order."""
    if type(tree) is dict:
        return {k: canonical(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(canonical(x) for x in tree)
    return tree


def tree_flatten(tree: Any):
    return pytree.tree_flatten(canonical(tree))


def tree_leaves(tree: Any) -> list:
    return pytree.tree_leaves(canonical(tree))


def tree_flatten_with_path(tree: Any):
    return pytree.tree_flatten_with_path(canonical(tree))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return pytree.tree_map(fn, canonical(tree), *map(canonical, rest))


@dataclasses.dataclass(frozen=True)
class ElemSpec:
    """Shape and dtype of one pytree leaf's ELEMENT (the jax
    ShapeDtypeStruct analog).  Not a registered pytree node, so it is a
    leaf wherever it sits in a tree."""

    shape: tuple
    dtype: torch.dtype


def bmask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a [..] bool mask against a [.., extra...] value tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def tree_where(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Elementwise select over matching pytrees; mask broadcasts per leaf."""
    return tree_map(lambda x, y: torch.where(bmask(mask, x), x, y), a, b)


def tree_changed(a: Any, b: Any) -> torch.Tensor:
    """Per-element 'any leaf differs' between two matching [P, N, ...]
    pytrees; returns a bool tensor of the shared leading shape."""
    out = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = x != y
        lead = min(x.dim(), 2)
        d = d.reshape(d.shape[:lead] + (-1,)).any(dim=-1) if d.dim() > lead else d
        out = d if out is None else (out | d)
    return out


def tree_zeros_like_elem(tree: Any, lead_shape: tuple[int, ...]) -> Any:
    """Zeros with each leaf's element (trailing) shape under a new lead."""
    return tree_map(lambda x: x.new_zeros(lead_shape + tuple(x.shape[2:])), tree)


def elem_spec(tree: Any) -> Any:
    """ElemSpecs of a [P, N, ...] pytree's element type."""
    return tree_map(lambda x: ElemSpec(tuple(x.shape[2:]), x.dtype), tree)


def gather_rows(tree: Any, idx: torch.Tensor) -> Any:
    """tree leaves [P, N, ...], idx [P, M] -> leaves [P, M, ...] (clipped)."""
    def one(t):
        ii = idx.clamp(0, t.shape[1] - 1)
        rows = torch.arange(t.shape[0], device=t.device)[:, None]
        return t[rows, ii]
    return tree_map(one, tree)


def scatter_rows(init: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Per-row scatter: init [nl, N, ...], idx [nl, M] (rows >= N drop),
    vals [nl, M, ...] -> updated copy [nl, N, ...].  Kept rows must be
    unique per partition."""
    nl, n = init.shape[:2]
    buf = torch.cat([init, init.new_zeros((nl, 1) + tuple(init.shape[2:]))], 1)
    rows = torch.arange(nl, device=init.device)[:, None]
    buf[rows, idx.clamp(0, n)] = vals.to(buf.dtype)
    return buf[:, :n].contiguous()


def vmap2(f: Callable) -> Callable:
    """vmap over the two leading (partition, element) axes.  Outputs are
    contiguous and on the inputs' device: vmap broadcasts an unbatched
    constant a UDF returns (`torch.tensor(1.0)`) from the CPU."""
    inner = torch.func.vmap(torch.func.vmap(f))

    def run(*args):
        dev = tree_leaves(args)[0].device
        return tree_map(lambda t: t.to(dev).contiguous(), inner(*args))
    return run


def nbytes_of(tree: Any) -> int:
    """Total byte size of a pytree of tensors (python int)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
