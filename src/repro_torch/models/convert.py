"""Carry the reference's parameters into the port.

`params_from_reference(tree, cfg, device)` takes the reference model's
value tree (`repro.models.layers.split_params(init_model(...))[0]`, its
leaves as numpy arrays) and returns the port's parameter dict for `cfg`.
Leaves are matched by key path, never by leaf order; every path of the
port's layout must be present with the same shape, and a path the port does
not have is an error.
"""
from __future__ import annotations

import numpy as np
import torch

from . import transformer as T


def _paths(tree, prefix=()):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _build(paths: dict) -> dict:
    root: dict = {}
    for path, leaf in paths.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def params_from_reference(tree: dict, cfg, device) -> dict:
    """The port's parameters for `cfg` holding the reference's values."""
    # the layout, as shapes only: a model on the meta device holds no data
    layout = _paths(T.init_model(cfg, generator=None, device="meta"))
    given = _paths(tree)
    missing = sorted(set(layout) - set(given))
    extra = sorted(set(given) - set(layout))
    if missing or extra:
        raise KeyError(f"reference parameters do not match the port's "
                       f"layout of {cfg.name}: missing "
                       f"{['/'.join(p) for p in missing]}, extra "
                       f"{['/'.join(p) for p in extra]}")
    out = {}
    for path, spec in layout.items():
        arr = np.asarray(given[path])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the port "
                             f"expects {tuple(spec.shape)}")
        out[path] = torch.from_numpy(arr.astype(np.float32)).to(device)
    return _build(out)
