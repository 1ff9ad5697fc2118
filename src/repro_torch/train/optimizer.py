"""AdamW over the parameter dict, in plain torch.

The port of `repro/train/optimizer.py`, with its math: global-norm
clipping, linear warmup then cosine decay to `min_lr_ratio`, bias
correction, and decoupled weight decay on every leaf (norms and embedding
included).  Not `torch.optim.AdamW`, whose schedule and clipping are not
the reference's.  The reference's update is functional; this one updates
the parameters and moments in place (under no_grad, with `torch._foreach_*`
over the leaves in sorted key order), which saves three copies of the
parameters, and returns them.  It takes the leaves in groups of at most
`GROUP_BYTES` (a larger leaf alone), so its three temporaries (the clipped
gradient, the denominator, the step) hold one group at a time: at
recurrentgemma-2b's 11.6 GB of f32 parameters, whole-tree temporaries
would take the step past one 80 GB card.  The arithmetic is elementwise,
so grouping changes no value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.tree import tree_leaves, tree_map

GROUP_BYTES = 1 << 30          # f32 bytes of one update group


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    step: int


def init(params: dict) -> OptState:
    zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=0)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32), a 0-d tensor."""
    norms = torch._foreach_norm([t.float() for t in tree_leaves(tree)])
    return torch.stack(norms).square().sum().sqrt()


def _groups(leaves: list) -> list[tuple[int, int]]:
    """[lo, hi) ranges of consecutive leaves of at most GROUP_BYTES of f32
    each (a leaf above it alone)."""
    out, lo, size = [], 0, 0
    for i, t in enumerate(leaves):
        n = t.numel() * 4
        if i > lo and size + n > GROUP_BYTES:
            out.append((lo, i))
            lo, size = i, 0
        size += n
    if leaves:
        out.append((lo, len(leaves)))
    return out


@torch.no_grad()
def update(cfg: AdamWConfig, params: dict, grads: dict, state: OptState):
    """-> (params, state, metrics); params and the moments change in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    leaves = [tree_leaves(t) for t in (params, state.m, state.v, grads)]
    for lo, hi in _groups(leaves[0]):
        p, m, v, gr = (x[lo:hi] for x in leaves)
        g = torch._foreach_mul([t.float() for t in gr], scale)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        del g
        denom = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m, b1c)
        torch._foreach_div_(delta, denom)
        del denom
        torch._foreach_add_(delta, p, alpha=cfg.weight_decay)
        torch._foreach_add_(p, delta, alpha=-lr)
        del delta
    return params, OptState(state.m, state.v, step), {"grad_norm": gnorm,
                                                      "lr": lr}
