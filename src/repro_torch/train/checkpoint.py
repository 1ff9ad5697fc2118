"""Sharded, atomic, async checkpointing (the port of
`repro.train.checkpoint`, DESIGN.md §6).

`Checkpointer` is the train loop's client of `core.snapshot.SnapshotStore`:
it names an arbitrary pytree's leaves by their key paths, copies them to
the host at once (`save`: the device-to-host copy is synchronous, the
file write runs on a daemon thread, so the loop overlaps it with the next
steps) and rebuilds a tree in a given structure on restore.  The store's
write / fsync / rename ladder makes a killed job see no torn checkpoint,
and a restore cleans torn `tmp.<step>/` directories.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from ..core.snapshot import SnapshotStore, flatten_with_paths, to_tensor
from ..core.tree import tree_flatten


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self._store = SnapshotStore(directory, keep=keep)
        self.dir = directory
        self.keep = keep

    @property
    def store(self) -> SnapshotStore:
        return self._store

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Copy the tree to host memory now; write it to disk on a thread
        (or before returning, `blocking`)."""
        _, spec = tree_flatten(tree)
        self._store.write(step, dict(flatten_with_paths(tree)),
                          {"step": step, "treedef": str(spec)},
                          blocking=blocking)

    def wait(self) -> None:
        self._store.wait()

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return self._store.all_steps()

    def latest_step(self) -> int | None:
        return self._store.latest_step()

    def restore(self, step: int, like: Any, device=None) -> Any:
        """The snapshot at `step` in `like`'s structure: tensor leaves on
        `device` (None: each like leaf's own), Python numbers as numbers.
        Stray `tmp.<step>/` directories are cleaned on the way."""
        host, manifest = self._store.read(step)
        dtypes = {k: v["dtype"]
                  for k, v in manifest.get("leaves", {}).items()}
        _, treedef = tree_flatten(like)
        leaves = []
        for k, leaf in flatten_with_paths(like):
            if isinstance(leaf, torch.Tensor):
                leaves.append(to_tensor(host[k], dtypes.get(k),
                                        device or leaf.device))
            else:
                leaves.append(type(leaf)(host[k].item()))
        return pytree.tree_unflatten(leaves, treedef)
