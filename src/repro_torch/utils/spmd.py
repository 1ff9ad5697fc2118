"""Spawning the ranks of a multi-process run: the port's counterpart of
`repro/utils/spmd.py`.  `shard` and `unshard`, which cut a graph into a
rank's rows and gather it back, live in `core/shard.py` and are named here
too.

`run_ranks` spawns one process a rank (the spawn start method), joins them
through a `FileStore` in a temporary directory (no port to collide on), and
fails, killing every rank, when one rank fails or the timeout passes: a
collective that the ranks run out of step hangs rather than raises.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from ..core.shard import shard, unshard

__all__ = ["run_ranks", "shard", "unshard"]


# seconds the other ranks get to exit after one fails
_GRACE = 3.0


def _rank_device(device: str, rank: int) -> torch.device:
    """The device of rank `rank`: "cuda" spreads the ranks over the cards
    (several ranks share a card when there are fewer cards than ranks);
    anything else is taken as it is."""
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _rank_main(fn, rank: int, world: int, tmp: str, backend: str,
               device: str, timeout: float, args: tuple) -> None:
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            # past the run's own deadline: run_ranks reports a hang first
            timeout=datetime.timedelta(seconds=2 * timeout))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"result.{rank}"), "wb") as f:
            pickle.dump(out, f)
    except Exception:
        with open(os.path.join(tmp, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *, args: tuple = (),
              backend: str = "nccl", device: str = "cuda",
              timeout: float = 600.0) -> list:
    """Run fn(rank, world, device, *args) in `world` spawned processes
    joined into one default group; the list of their return values, in
    rank order (pickled: plain data).  `fn` must be importable by name.

    Defaults to the card and NCCL; several ranks on one card need
    backend="gloo" (NCCL refuses two ranks on one device), and the CPU
    device="cpu", backend="gloo".  Raises RuntimeError when a rank fails
    (with every failed rank's traceback) and TimeoutError when `timeout`
    seconds pass, after killing every rank still running.  The group's
    collectives time out later than that, so a hang is reported as one."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, tmp, backend, device,
                                   timeout, args))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                if any(proc.exitcode not in (None, 0) for proc in procs):
                    # its peers fail soon after, inside a collective: a
                    # short grace lets each report its own traceback
                    for proc in procs:
                        proc.join(_GRACE)
                    failed = [r for r, proc in enumerate(procs)
                              if proc.exitcode not in (None, 0)]
                    raise RuntimeError(_failure(tmp, procs, failed))
                running = [proc for proc in procs if proc.exitcode is None]
                if not running:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: ranks {[procs.index(p) for p in running]}"
                        f" still running after {timeout} s")
                running[0].join(0.05)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
            for proc in procs:
                proc.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result.{r}"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _failure(tmp: str, procs, failed: list[int]) -> str:
    """Which ranks failed, and each one's traceback as the rank wrote it
    (a rank's peers may fail after it, inside a collective)."""
    lines = [f"run_ranks: ranks {failed} failed (exit codes "
             f"{[procs[r].exitcode for r in failed]})"]
    for r in failed:
        path = os.path.join(tmp, f"error.{r}")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r}\n{f.read()}")
    return "\n".join(lines)
