"""A step captured once as a CUDA graph and replayed.

The reference compiles its Pregel drivers: `pregel` runs `jax.jit` of the
superstep, one program launched once a superstep, and `pregel_fused` lowers
the whole loop to one `lax.while_loop`.  PyTorch runs eagerly, so a
superstep costs the host one Python dispatch per op.  `Replay` is the
port's counterpart of the compiled step: it captures the step once with
`torch.cuda.graph` and replays it, one graph launch a step.

The step maps a carry to (carry', out).  The carry is a pytree: dicts,
lists, tuples, dataclasses (`GraphView`, `WireLog`, ...) and
`wire.ResidentLeaf`s are walked; tensors are its dynamic half, and every
other value (the view's `dirs` / `stale` strings, a plan's ints, None) is
its static half, compared by equality.  `out` is what the step returns
beside the carry (the live count, the metrics) and is not fed back.

- The carry's tensors are copied once into static buffers, which the
  graph reads; the copy of each new carry tensor into its buffer is
  captured in the same graph (a tensor the step passes through, which is
  its own buffer, is not copied; one that aliases another buffer is
  staged first).
- The static half must be a fixed point: the capture raises if the step
  would return another treedef, dtype, shape or view plan, instead of
  replaying a stale one.  The plan settles after a graph's first, cold
  ship, so the drivers run that superstep eagerly before they capture.
- The capture comes after that eager step, so the kernels are built,
  their attributes set and the lazy handles made before capture begins.
  A step that runs code the eager step did not (a transport plan first
  used later in a run) is made with `defer=True`: its first step runs
  eagerly into the buffers and the second one captures.
- A replay adds the launches its capture recorded to `ops.launch_counts`,
  and the route ships it recorded to `transport.SHIP_EVENTS` (the capture
  itself launches and ships nothing).
- `load(carry)` copies another carry of the same static half into the
  buffers: a driver that switches between captured steps (one per
  transport plan) hands the current state to the next one.
- On the CPU (`capture=False`) the same object runs the step eagerly into
  the same buffers and checks the static half at every step, so the CPU
  tests exercise the buffers, the check and the commit.
- `close()` (or leaving the `with` block) releases the graph and its
  memory pool; `close_all` releases several with one `empty_cache`.  A
  capture that fails raises; nothing falls back to an eager run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from . import transport as transport_mod
from .wire import ResidentLeaf
from ..kernels import ops as kops


# captures made since the last reset, the host seconds they took, of those
# the seconds in capture_end (the graph's instantiation), and the seconds
# close() took to give the pools back (read by chip_smoke.py, the card
# tests and scripts beside `ops.launch_counts`)
stats = {"captures": 0, "capture_s": 0.0, "instantiate_s": 0.0,
         "release_s": 0.0}


def reset_stats() -> None:
    stats.update(captures=0, capture_s=0.0, instantiate_s=0.0,
                 release_s=0.0)


class StaticHalfChanged(RuntimeError):
    """The step returned a carry whose static half differs from its
    input's: a replay would run a stale plan."""


def _flatten(x, out: list):
    """(spec, appending x's tensors to `out`): the spec is x's static half,
    hashable and comparable."""
    if isinstance(x, torch.Tensor):
        out.append(x)
        return ("T", x.dtype, tuple(x.shape), x.device)
    if isinstance(x, ResidentLeaf):
        return ("R", x.kind, x.dtype, x.block, _flatten(x.payload, out),
                _flatten(x.scale, out))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("D", type(x), tuple((f.name, _flatten(getattr(x, f.name), out))
                                    for f in dataclasses.fields(x)))
    if type(x) is dict:
        return ("M", tuple((k, _flatten(v, out)) for k, v in x.items()))
    if type(x) in (list, tuple):
        return ("L", type(x), tuple(_flatten(v, out) for v in x))
    return ("C", x)


def _unflatten(spec, it):
    kind = spec[0]
    if kind == "T":
        return next(it)
    if kind == "R":
        _, k, dtype, block, ps, ss = spec
        payload = _unflatten(ps, it)
        return ResidentLeaf(payload, _unflatten(ss, it), k, dtype, block)
    if kind == "D":
        return spec[1](**{n: _unflatten(s, it) for n, s in spec[2]})
    if kind == "M":
        return {k: _unflatten(s, it) for k, s in spec[1]}
    if kind == "L":
        return spec[1](_unflatten(s, it) for s in spec[2])
    return spec[1]


def flatten(tree) -> tuple[list, Any]:
    """(tensors, static half) of a carry."""
    tensors: list = []
    spec = _flatten(tree, tensors)
    return tensors, spec


def unflatten(spec, tensors) -> Any:
    return _unflatten(spec, iter(tensors))


def _same(t: torch.Tensor, b: torch.Tensor) -> bool:
    """Is t the buffer b itself (a passed-through tensor)?"""
    return (t.data_ptr() == b.data_ptr() and t.shape == b.shape
            and t.stride() == b.stride() and t.dtype == b.dtype)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class Replay:
    """A step over a carry, run into static buffers; captured once as a
    CUDA graph and replayed when `capture` is true, else run eagerly.

    step(carry) -> (carry', out).  `run()` advances the carry one step
    and returns that step's `out` (on the card: the graph's own output
    tensors, which the next replay overwrites).  `carry` is the current
    carry over the static buffers."""

    def __init__(self, step: Callable, carry: Any, *, capture: bool,
                 defer: bool = False):
        self._step = step
        tensors, self._spec = flatten(carry)
        self._bufs = [t.clone() for t in tensors]
        self._out = None
        self._out_spec = None
        self._graph = None
        self._counts: dict[str, int] = {}
        self._ships: list = []
        # defer: run the first step eagerly and capture at the second, for
        # a step whose kernels have not all run eagerly yet
        self._pending = capture and defer
        if capture and not defer:
            self._capture()

    @property
    def carry(self) -> Any:
        return unflatten(self._spec, self._bufs)

    def _commit(self, new: Any) -> None:
        """Check `new`'s static half against the carry's and copy its
        tensors into the buffers."""
        tensors, spec = flatten(new)
        if spec != self._spec:
            raise StaticHalfChanged(
                "the step changed its carry's static half (treedef, dtype, "
                "shape or view plan); a replay would run a stale plan:\n"
                f"  before {self._spec}\n  after  {spec}")
        bufs = {_storage(b) for b in self._bufs}
        staged = []
        for b, t in zip(self._bufs, tensors):
            if _same(t, b):
                continue
            if _storage(t) in bufs:     # another slot's buffer: read first
                t = t.clone()
            staged.append((b, t))
        for b, t in staged:
            b.copy_(t)

    def load(self, carry: Any) -> None:
        """Make `carry` (same static half) the current carry."""
        self._commit(carry)

    def _eager(self):
        new, out = self._step(self.carry)
        self._commit(new)
        return out

    def _capture(self) -> None:
        before = kops.launch_counts()
        n_ships = len(transport_mod.SHIP_EVENTS)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # capture_begin / capture_end on a side stream, as torch.cuda.graph
        # does, without its gc.collect() and empty_cache(), which cost a
        # large process more than the capture; the graph gets a private
        # memory pool of its own
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                self._out = self._eager()
            finally:
                t1 = time.perf_counter()
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        stats["captures"] += 1
        stats["capture_s"] += time.perf_counter() - t0
        stats["instantiate_s"] += time.perf_counter() - t1
        after = kops.launch_counts()
        self._counts = {k: n - before.get(k, 0) for k, n in after.items()
                        if n != before.get(k, 0)}
        # the capture recorded these launches; none of them ran
        kops.add_launch_counts({k: -n for k, n in self._counts.items()})
        self._ships = transport_mod.SHIP_EVENTS[n_ships:]
        del transport_mod.SHIP_EVENTS[n_ships:]
        self._graph = graph

    def run(self) -> Any:
        """One step: replay the graph, or run the step eagerly (the first
        step of a deferred capture, which the second one captures)."""
        if self._pending and self._out_spec is not None:
            self._pending = False
            self._capture()
        if self._graph is not None:
            self._graph.replay()
            kops.add_launch_counts(self._counts)
            transport_mod.SHIP_EVENTS.extend(self._ships)
            return self._out
        out = self._eager()
        _, spec = flatten(out)
        if self._out_spec is None:
            self._out_spec = spec
        elif spec != self._out_spec:
            raise StaticHalfChanged(
                "the step's output changed its static half between steps: "
                f"{self._out_spec} -> {spec}")
        return out

    def _release(self) -> bool:
        """Drop the graph and the outputs in its pool; was there one?"""
        had = self._graph is not None
        if had:
            self._graph.reset()
        self._graph = None
        self._out = None
        return had

    def close(self) -> None:
        """Release the graph and the outputs that live in its pool, and
        give the pool's memory back to the device (the caller drops its
        own references to `run()`'s outputs first).  A released private
        pool keeps its segments cached until `torch.cuda.empty_cache()`:
        without it, a process that captured 90 supersteps of rmat(22,16)
        ran out of the card's 80 GB."""
        close_all([self])

    def __enter__(self) -> "Replay":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def close_all(replays) -> None:
    """Close several replays with one `empty_cache`, which costs a large
    process milliseconds each time."""
    t0 = time.perf_counter()
    if sum(rep._release() for rep in replays):
        torch.cuda.empty_cache()
        stats["release_s"] += time.perf_counter() - t0
