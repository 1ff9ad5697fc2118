"""Cross-partition exchange: the port's single-device executor.

Every distributed primitive is written against one contract,

    transpose(x)[p, q, ...] == x[q, p, ...]      for x of shape [P, P, ...],

"partition q's block for partition p arrives at p, labelled q".
`LocalExchange` holds all P partitions on one device, where the exchange is
an axis transpose.  A multi-device executor over `torch.distributed`
(all_to_all) comes with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


class Exchange:
    """Executor interface.  `p` is the number of graph partitions."""

    p: int

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Mesh-global sum of a per-executor quantity (local value here)."""
        return x

    def home_rows(self, nl: int) -> torch.Tensor:
        """[nl] int32 global partition ids of this executor's rows."""
        return torch.arange(nl, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class LocalExchange(Exchange):
    """Single-device executor: the exchange transposes the block matrix."""

    p: int

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.p or x.shape[1] != self.p:
            raise ValueError(f"expected [{self.p}, {self.p}, ...], got "
                             f"{tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()
