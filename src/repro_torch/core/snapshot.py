"""Atomic sharded snapshots for train and graph state (the port of
`repro.core.snapshot`, DESIGN.md §6).

`SnapshotStore` writes one snapshot as `<dir>/step_<N>/` holding
`shards.npz` (named host arrays) and `manifest.json` (leaf specs and the
caller's metadata): the shards and the manifest land in `tmp.<N>/`, the
manifest is fsync'd, the directory renamed in whole and the parent
directory fsync'd, then old snapshots are collected.  Readers ignore torn
`tmp.<N>/` directories and clean them.  One write is in flight at a time,
on a daemon thread; the caller's device-to-host copy happens before it
starts (`host_arrays`: one pinned copy a tensor, one sync a snapshot).

The format is the reference's: the same shard names (`jax.tree_util.keystr`
paths, "vdata['pr']"), shapes, dtypes and manifest, so a snapshot of a
reference run restores here and the other way round.  bf16 and fp8
tensors, which numpy lacks, are stored as their integer bits with the
torch dtype's name in the manifest.

The graph user: `save_pregel` / `restore_pregel` snapshot the Pregel carry
at a superstep boundary (the warm graph with its view, whose static half
goes in the manifest, the live count and the concrete transport policy of
the next superstep), and `restore_pregel_elastic` rebuilds the graph on
another partition count from the edge list and per-id vertex facts (the
view comes back cold).

A graph sharded over an `SpmdExchange` (`core/shard.py`) snapshots whole:
`save_pregel` gathers it to rank 0 (a collective every rank joins; no
other rank holds the global graph), which writes the files a
`LocalExchange` run of the same graph would write; the restores read those
files on every rank and keep the rank's rows, so a snapshot taken on one
world restores on another.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import partition as part_mod
from . import wire as wire_mod
from .exchange import spmd_of
from .transport import TransportPolicy
from .tree import tree_flatten, tree_flatten_with_path, tree_leaves
from .view import GraphView, WireLog

# torch dtypes numpy cannot hold: stored as their integer bits
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
         torch.float8_e4m3fn: torch.int8, torch.float8_e5m2: torch.int8}
_BY_NAME = {str(d).replace("torch.", ""): d for d in _BITS}


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """[(key string, leaf)] in flatten order (dict keys sorted), the key
    strings `jax.tree_util.keystr` gives: the shard names of every
    snapshot."""
    flat = tree_flatten_with_path(tree)[0]
    return [(pytree.keystr(kp), leaf) for kp, leaf in flat]


def host_arrays(arrays: dict) -> tuple[dict, dict]:
    """(numpy arrays, {name: torch dtype name} of the narrow floats) of a
    dict of tensors and arrays.  Tensors on the card copy into pinned
    host buffers without blocking, and the host waits once for all of
    them."""
    pending, narrow, out = [], {}, {}
    for k, v in arrays.items():
        if not isinstance(v, torch.Tensor):
            out[k] = np.asarray(v)
            continue
        v = v.detach()
        if v.dtype in _BITS:
            narrow[k] = str(v.dtype).replace("torch.", "")
            v = v.contiguous().view(_BITS[v.dtype])
        if v.device.type == "cuda":
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            pending.append(v.device)
            out[k] = buf
        else:
            out[k] = v.clone()   # the carry may change under the writer
    for dev in set(pending):
        torch.cuda.synchronize(dev)
    return ({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in out.items()}, narrow)


def to_tensor(arr: np.ndarray, dtype_name: str | None, device) -> torch.Tensor:
    """A stored array as a tensor on `device`, narrow floats reinterpreted
    from their bits (also a reference snapshot's, which numpy loads as
    raw two-byte or one-byte voids)."""
    narrow = _BY_NAME.get(dtype_name or "")
    if narrow is not None:
        bits = np.ascontiguousarray(arr).view(
            np.int16 if _BITS[narrow] == torch.int16 else np.int8)
        return torch.from_numpy(bits.copy()).view(narrow).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


class SnapshotStore:
    """Atomic, async, sharded snapshot directory; the `keep` newest
    snapshots survive collection."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._inflight: int | None = None
        # per written snapshot: step, bytes on disk, the host seconds of
        # its device-to-host copy and of its file write; the last read's
        self.log: list[dict] = []
        self.last_read_s = 0.0

    # ------------------------------------------------------------------ save
    def write(self, step: int, arrays: dict, manifest: dict | None = None,
              *, blocking: bool = True) -> None:
        """Write one snapshot.  `arrays` are host data or tensors (copied
        here, before the thread starts); `manifest` entries ride beside
        the store's own leaf specs."""
        t0 = time.perf_counter()
        host, narrow = host_arrays(arrays)
        copy_s = time.perf_counter() - t0
        self.wait()                      # one outstanding write at a time
        self._inflight = step
        self._thread = threading.Thread(
            target=self._write, args=(step, host, narrow,
                                      dict(manifest or {}), copy_s),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict, narrow: dict, manifest: dict,
               copy_s: float = 0.0) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shards.npz"),
                 **{k.replace("/", "\\"): v for k, v in host.items()})
        manifest = dict(manifest)
        manifest.setdefault("step", step)
        manifest["leaves"] = {
            k: {"shape": list(v.shape), "dtype": narrow.get(k, str(v.dtype))}
            for k, v in host.items()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomicity boundary
        self._fsync_dir()                # and the rename itself durable
        self._inflight = None
        self.log.append({
            "step": step, "copy_s": copy_s,
            "write_s": time.perf_counter() - t0,
            "bytes": sum(os.path.getsize(os.path.join(final, n))
                         for n in os.listdir(final))})
        self._gc()

    def _fsync_dir(self) -> None:
        """fsync the snapshot directory: the rename is directory metadata.
        Best effort where the filesystem refuses directory fds."""
        try:
            fd = os.open(self.dir, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """Committed snapshots only: `tmp.*` never counts."""
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def clean_tmp(self) -> list[str]:
        """Remove torn `tmp.<step>/` directories a killed writer left (the
        write in flight is spared); returns what was removed."""
        removed = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("tmp."):
                continue
            if self._inflight is not None and name == f"tmp.{self._inflight}":
                continue
            shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
            removed.append(name)
        return removed

    def read(self, step: int) -> tuple[dict, dict]:
        """(arrays, manifest) of one committed snapshot; stray tmp
        directories are cleaned on the way."""
        t0 = time.perf_counter()
        self.clean_tmp()
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "shards.npz")) as data:
            arrays = {k.replace("\\", "/"): data[k] for k in data.files}
        self.last_read_s = time.perf_counter() - t0
        return arrays, manifest


# ---------------------------------------------------------------------------
# Graph / Pregel snapshots
# ---------------------------------------------------------------------------
def _named_leaves(prefix: str, tree) -> dict:
    return {prefix + k: v for k, v in flatten_with_paths(tree)}


class _Reader:
    """Tensors of one read snapshot on one device; with `rows`, only those
    rows of each [P, ...] array (a rank's share of a sharded graph)."""

    def __init__(self, arrays: dict, manifest: dict, device,
                 rows: slice | None = None):
        self.arrays = arrays
        self.dtypes = {k: v["dtype"]
                       for k, v in manifest.get("leaves", {}).items()}
        self.device = device
        self.rows = rows

    def __call__(self, key: str) -> torch.Tensor:
        arr = self.arrays[key]
        if self.rows is not None:
            arr = arr[self.rows]
        return to_tensor(arr, self.dtypes.get(key), self.device)

    def like(self, like, prefix: str):
        """A pytree in `like`'s structure from prefixed shard names."""
        _, treedef = tree_flatten(like)
        keys = [prefix + k for k, _ in flatten_with_paths(like)]
        return pytree.tree_unflatten([self(k) for k in keys], treedef)


def _plain_names(tree) -> list[str]:
    """Dict-pytree leaf names ("pr", "a.b"): the elastic keys, rebuilt on
    restore without a `like` structure."""
    names = []
    for k, _ in flatten_with_paths(tree):
        name = k.replace("']['", ".").strip("[]'\"")
        if not name or name in names:
            raise ValueError(
                "elastic snapshots need dict-shaped vdata/edata with unique "
                f"string keys; got leaf path {k!r}")
        names.append(name)
    return names


def graph_arrays(g, *, elastic: bool = True) -> tuple[dict, dict]:
    """(arrays, manifest) capturing one Graph; the manifest holds what is
    static on the live object (the view's filled directions and stale
    records, vmask_full), since arrays restored under a wrong static half
    would corrupt the delta-shipping plan."""
    arrays = {
        **_named_leaves("vdata", g.vdata),
        **_named_leaves("edata", g.edata),
        "vmask": g.vmask, "emask": g.emask, "active": g.active,
        "home_vid": g.s.home_vid, "home_mask": g.s.home_mask,
    }
    manifest: dict = {
        "kind": "graph",
        "p": int(g.s.p),
        "vmask_full": bool(g.vmask_full),
        "view": None,
        "wire_log": g.wire_log is not None,
        "wall_time": time.time(),
    }
    if g.wire_log is not None:
        arrays["wire_log/ships"] = g.wire_log.ships
        arrays["wire_log/bytes_shipped"] = g.wire_log.bytes_shipped
        arrays["wire_log/bytes_accounted"] = g.wire_log.bytes_accounted
    if g.view is not None:
        v = g.view
        # narrow-resident mirrors snapshot decoded: what every consumer
        # reads; the next ship re-encodes, unchanged blocks exactly
        arrays.update(_named_leaves("view/mirror",
                                    wire_mod.decode_tree(v.mirror)))
        arrays.update(_named_leaves("view/dirty", v.dirty))
        arrays.update({"view/vis": v.vis, "view/filled": v.filled,
                       "view/active": v.active, "view/vis_dirty": v.vis_dirty})
        manifest["view"] = {"dirs": list(v.dirs), "vis_dirs": v.vis_dirs,
                            "stale": list(v.stale), "vis_stale": v.vis_stale}
    if elastic:
        svid, dvid, edata = g.edges_to_numpy()
        arrays["elastic/src"] = svid
        arrays["elastic/dst"] = dvid
        for name, leaf in zip(_plain_names(edata), tree_leaves(edata)):
            arrays[f"elastic/edata/{name}"] = leaf
        manifest["elastic"] = {"edata": _plain_names(edata),
                               "vdata": _plain_names(g.vdata)}
    return arrays, manifest


def save_pregel(store: SnapshotStore, step: int, g, policy=None, *,
                live=None, blocking: bool = True,
                elastic: bool = True) -> None:
    """Snapshot the Pregel carry at a superstep boundary: `step` is the next
    superstep to run, `policy` the concrete transport it would run with
    (adapt_policy's output).  A sharded graph is gathered to rank 0 and
    written there, blocking; every rank returns once the files are
    committed."""
    spmd = spmd_of(g.ex)
    if spmd is not None:
        from .shard import unshard      # shard.py imports graph.py
        g = unshard(g, spmd.group, dst=0)
        blocking = True
    if g is not None:
        arrays, manifest = graph_arrays(g, elastic=elastic)
        manifest["kind"] = "pregel"
        manifest["superstep"] = int(step)
        manifest["live"] = None if live is None else int(live)
        manifest["policy"] = (None if policy is None
                              else dataclasses.asdict(policy))
        store.write(step, arrays, manifest, blocking=blocking)
    if spmd is not None:
        dist.barrier(group=spmd.group)


def _manifest_policy(manifest: dict) -> TransportPolicy | None:
    d = manifest.get("policy")
    if d is None:
        return None
    d = dict(d)
    d["cap"] = None if d.get("cap") is None else int(d["cap"])
    for f in ("capacity_fracs", "capacity_fracs_back"):
        if d.get(f) is not None:
            d[f] = tuple(d[f])          # JSON gives lists; the plan hashes
    return TransportPolicy(**d)


def _read_latest(store: SnapshotStore, step: int | None):
    if step is None:
        step = store.latest_step()
        if step is None:
            raise FileNotFoundError(f"no snapshots in {store.dir}")
    return (step,) + store.read(step)


def restore_pregel(store: SnapshotStore, like, step: int | None = None):
    """Warm restore onto the same partition count: the Graph in `like`'s
    structure (its structure, host build and executor shared: a resumed
    process rebuilds the same structure deterministically), the view
    included, on `like`'s device.  A sharded `like` takes its rank's rows.
    Returns (graph, next_superstep, policy, live)."""
    step, arrays, manifest = _read_latest(store, step)
    if int(manifest["p"]) != int(like.s.p):
        raise ValueError(
            f"snapshot has p={manifest['p']}, this graph has p={like.s.p}; "
            "use restore_pregel_elastic to re-shard")
    spmd, rows = spmd_of(like.ex), None
    if spmd is not None:
        nl = like.vmask.shape[0]
        rows = slice(spmd.rank * nl, (spmd.rank + 1) * nl)
    rd = _Reader(arrays, manifest, like.device, rows)
    vdata = rd.like(like.vdata, "vdata")
    edata = rd.like(like.edata, "edata")
    view = None
    if manifest.get("view") is not None:
        va = manifest["view"]
        dirs = tuple(va["dirs"])
        if "stale" in va:
            stale, vis_stale = tuple(va["stale"]), va["vis_stale"]
        else:
            # an older snapshot: boolean clean marks, one dirty row
            stale = tuple("" if cl else d for cl, d in zip(va["clean"], dirs))
            vis_stale = "" if va.get("vis_clean", True) else va["vis_dirs"]

        def widen(m):
            if m.dim() >= 3 and m.shape[1] == 2:
                return m
            return m[:, None].expand((m.shape[0], 2) + tuple(m.shape[1:]))
        dirty = rd.like(vdata, "view/dirty")
        view = GraphView(
            mirror=rd.like(vdata, "view/mirror"),
            vis=rd("view/vis"), filled=rd("view/filled"),
            active=rd("view/active"),
            dirty=pytree.tree_map(widen, dirty),
            vis_dirty=widen(rd("view/vis_dirty")),
            dirs=dirs, vis_dirs=va["vis_dirs"],
            stale=stale, vis_stale=vis_stale)
    wire_log = like.wire_log
    if manifest.get("wire_log") and "wire_log/ships" in arrays:
        wire_log = WireLog(ships=rd("wire_log/ships"),
                           bytes_shipped=rd("wire_log/bytes_shipped"),
                           bytes_accounted=rd("wire_log/bytes_accounted"))
    g = like.replace(vdata=vdata, edata=edata, vmask=rd("vmask"),
                     emask=rd("emask"), active=rd("active"), view=view,
                     wire_log=wire_log,
                     vmask_full=bool(manifest["vmask_full"]))
    return g, int(manifest.get("superstep", step)), \
        _manifest_policy(manifest), manifest.get("live")


def restore_pregel_elastic(store: SnapshotStore, *, num_partitions: int,
                           step: int | None = None, ex=None,
                           partitioner: str = "2d", device=None):
    """Elastic restore onto another partition count: rebuild through
    `Graph.from_edges` from the snapshot's edge list and per-id vertex
    facts, then place vmask / active by vertex id.  The view comes back
    cold (mirror slots are facts of one layout).  `device`: the card
    unless the caller asks for the CPU.  Under an `SpmdExchange` `ex` each
    rank rebuilds the graph on the host and moves only its own rows to
    `device`.  Returns (graph, next_superstep, policy, live)."""
    from .graph import Graph, resolve_device   # graph.py imports this
    from .shard import shard                   # module's users

    step, arrays, manifest = _read_latest(store, step)
    if "elastic/src" not in arrays:
        raise ValueError("snapshot was written with elastic=False")
    el = manifest["elastic"]
    home_mask = arrays["home_mask"].astype(bool)
    vk = arrays["home_vid"][home_mask].astype(np.int64)
    vvals = {n: arrays["vdata['" + n.replace(".", "']['") + "']"][home_mask]
             for n in el["vdata"]}
    default = {n: np.zeros(v.shape[1:], v.dtype) for n, v in vvals.items()}
    edata = {n: arrays[f"elastic/edata/{n}"] for n in el["edata"]}
    spmd = spmd_of(ex)
    dev = resolve_device(device)
    g = Graph.from_edges(
        arrays["elastic/src"], arrays["elastic/dst"], edge_values=edata,
        vertex_keys=vk, vertex_values=vvals, default_vertex=default,
        num_partitions=num_partitions, partitioner=partitioner,
        device="cpu" if spmd is not None else dev)
    if ex is not None:
        g = g.replace(ex=ex)
    vmask = part_mod.place_vertex_rows(
        g.host, vk, arrays["vmask"][home_mask], fill=False)
    active = part_mod.place_vertex_rows(
        g.host, vk, arrays["active"][home_mask], fill=False)
    g = g.replace(
        vmask=torch.from_numpy(vmask).to(g.device) & g.s.home_mask,
        active=torch.from_numpy(active).to(g.device), view=None,
        vmask_full=bool(manifest["vmask_full"]))
    if spmd is not None:
        g = shard(g, spmd.rank, spmd.world, device=dev)
    return g, int(manifest.get("superstep", step)), \
        _manifest_policy(manifest), manifest.get("live")
