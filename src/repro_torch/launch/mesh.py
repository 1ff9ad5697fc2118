"""The graph engine's process groups (the port of `repro/launch/mesh.py`).

The reference lays its chips out as named mesh axes; the port's graph
engine needs one flat "parts" axis, which is a `torch.distributed` group
of ranks, each holding P / world partitions through an `SpmdExchange`.
The ranks are made first (`utils.spmd.run_ranks`, or any launcher that
calls `init_process_group`); these functions name groups of them.  The
reference's production LM meshes (16 x 16 and 2 x 16 x 16) belong with the
LM sharding rules and are not ported here.
"""
from __future__ import annotations

import torch.distributed as dist


def make_graph_mesh(world: int | None = None):
    """The flat "parts" group over the first `world` ranks (None: every
    rank; the default group).  A collective when it makes a new group:
    every rank calls it, and a rank outside gets
    `dist.GroupMember.NON_GROUP_MEMBER`."""
    have = dist.get_world_size()
    if world is None or world == have:
        return dist.group.WORLD
    if world > have:
        raise RuntimeError(f"a graph group of {world} ranks needs {world} "
                           f"ranks, have {have}")
    return dist.new_group(list(range(world)))


def make_restore_mesh(num_parts: int):
    """The group an ELASTIC restore runs on (DESIGN.md §6): a snapshot
    taken on one world re-shards through
    `core.snapshot.restore_pregel_elastic(num_partitions=num_parts)` onto
    the first `num_parts` ranks, one partition each; partition count is
    snapshot data, not code."""
    return make_graph_mesh(num_parts)


def in_group(group) -> bool:
    """Does this rank belong to `group` (a result of the functions above)?"""
    return group is not None and group != dist.GroupMember.NON_GROUP_MEMBER


def mesh_axis_sizes(group=None) -> dict[str, int]:
    """{"parts": ranks of the group} (the reference's axis-name -> size
    map of a mesh)."""
    return {"parts": dist.get_world_size(group)}
