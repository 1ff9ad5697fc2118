"""Deterministic wire-fault injection for the chaos harness (the port of
`repro.core.fault`, DESIGN.md §6).

`FaultyExchange` wraps an executor and corrupts the buffers its
collectives return, after the wire moved them: where a flaky link, a DMA
bit flip or a misrouted block would land.  A static `FaultPlan` decides
every injection, so a chaos run is reproducible bit for bit.

Targeting counts collectives.  Every transpose / ring_transpose gets an
index; the plan hits indices (`calls=(0, 2)`) or all of them, and
`max_events` caps the corrupted collectives.  The transport's integrity
ladder (`core/transport.py`) brackets its attempts with `note_attempt(k)`,
so a plan states a transient fault (`attempts=(0,)`: the retry is clean)
or a persistent one (`attempts=(0, 1)`: the route degrades to the raw
dense ship, attempt 2, which the plan leaves clean).  `attempts=None`
corrupts regardless of the bracket: the negative control.

The reference decides at trace time: a jitted superstep traces once per
program (the graph's static half and the concrete transport plan), the
counter advances only while it traces, and every execution of a compiled
program repeats the corruptions its trace baked in.  The port's drivers
run Python every superstep on the CPU, and once per capture on the card,
so they bracket each superstep with the key of the program the reference
would run (`program(key)`): the first superstep under a key decides and
records, and a later superstep under the same key replays those
decisions without advancing the counter.  Calls outside a bracket decide
each time, as the reference's eager calls do.  `new_scope()` forgets the
programs: each driver call is a new jit in the reference.

`psum` and `pmax` are never corrupted: plan decisions (overflow,
verdicts) must stay uniform across the mesh.  Around an `SpmdExchange`
each rank wraps its own executor; the ranks run the same collectives in
the same order, so their counters agree and a plan hits the same calls on
every rank, and a `route` names global partitions (`home_rows`), so only
the rank that holds the receiver corrupts its block.  `all_gather_rows`
is not wrapped, as in the reference, so the base method raises under the
injector.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from .exchange import Exchange
from .wire import _INT_VIEW, WireCodec

MODES = ("corrupt", "zero", "drop", "misroute")

# mantissa-only XOR pattern for f32 bit flips: never makes a NaN or an Inf,
# so the corruption survives arithmetic and must be caught
_F32_FLIP = np.int32(0x0007FFF0)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static description of what to break.

    mode:     "corrupt" XORs payload bits (mantissa only for floats);
              "zero" zeroes the targeted block; "drop" zeroes every block
              headed to the target receiver; "misroute" delivers the ring
              neighbour's block instead.
    attempts: integrity-ladder attempts to hit; None: always, (): never.
    calls:    indices of collective calls to hit, or "all".
    route:    (recv, send) global partition pair to hit, or None: every
              block.
    max_events: cap on corrupted collectives (None: no cap).
    seed:     corruption pattern seed (each event's pattern derives from
              seed and call index)."""

    mode: str = "corrupt"
    attempts: tuple | None = (0,)
    calls: Any = "all"
    route: tuple | None = None
    max_events: int | None = None
    seed: int = 0


@dataclasses.dataclass(eq=False)
class FaultyExchange(Exchange):
    """Fault-injecting decorator over a real executor (identity equality:
    its counters are mutable)."""

    inner: Exchange
    plan: FaultPlan = FaultPlan()

    def __post_init__(self):
        if self.plan.mode not in MODES:
            raise ValueError(
                f"unknown fault mode {self.plan.mode!r}; one of {MODES}")
        self.p = self.inner.p
        self.reset()

    # --- stats / control -------------------------------------------------
    def note_attempt(self, a: int) -> None:
        """Integrity-ladder bracket (called by transport.ship_transport)."""
        self._attempt = a

    def reset(self) -> None:
        self._attempt = None
        self._calls = 0         # the reference's trace-time call counter
        self._events = 0        # corrupted collectives decided so far
        self.new_scope()

    def new_scope(self) -> None:
        """Forget the recorded programs (a driver call's first program
        traces anew, as a new jit does)."""
        self._programs: dict = {}
        self._record: list | None = None
        self._replay: list | None = None
        self._replay_i = 0

    @contextlib.contextmanager
    def program(self, key):
        """Bracket one superstep of the program `key` (hashable): the first
        time it decides and records, later it replays."""
        seen = self._programs.get(key)
        if seen is None:
            self._programs[key] = self._record = []
        else:
            self._replay, self._replay_i = seen, 0
        try:
            yield
        finally:
            self._record = self._replay = None

    @property
    def events(self) -> int:
        """Collectives corrupted so far (decisions, as the reference counts
        at trace time)."""
        return self._events

    # --- Exchange interface ----------------------------------------------
    @property
    def codec(self) -> WireCodec | None:
        return self.inner.codec

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        return self._maybe_corrupt(self.inner.transpose(x))

    def ring_transpose(self, x: torch.Tensor) -> torch.Tensor:
        return self._maybe_corrupt(self.inner.ring_transpose(x))

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        # ring stages pass through; ring_transpose corrupts its assembled
        # result, so both wire schedules show the ladder the same faults
        return self.inner.ppermute(x, shift)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner.psum(x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner.pmax(x)

    def home_rows(self, nl: int, device=None) -> torch.Tensor:
        return self.inner.home_rows(nl, device=device)

    # --- injection -------------------------------------------------------
    def _decide(self, out: torch.Tensor) -> tuple[int, bool]:
        i = self._calls
        self._calls += 1
        plan = self.plan
        if plan.attempts is not None and self._attempt not in plan.attempts:
            return i, False
        if plan.calls != "all" and i not in tuple(plan.calls):
            return i, False
        if plan.max_events is not None and self._events >= plan.max_events:
            return i, False
        if out.dim() < 2:
            return i, False
        self._events += 1
        return i, True

    def _maybe_corrupt(self, out: torch.Tensor) -> torch.Tensor:
        if self._replay is not None:
            if self._replay_i >= len(self._replay):
                raise RuntimeError(
                    "a replayed program ran more collectives than its first "
                    "superstep recorded")
            i, hit = self._replay[self._replay_i]
            self._replay_i += 1
        else:
            i, hit = self._decide(out)
            if self._record is not None:
                self._record.append((i, hit))
        return _apply_fault(out, self.plan, self.inner, salt=i) if hit else out


def _block_mask(out: torch.Tensor, plan: FaultPlan,
                inner: Exchange) -> torch.Tensor:
    """[nl, P] bool: the received partner blocks the fault hits.  Rows are
    global receiver ids (home_rows), so a route names one physical link.
    Made on the device (a captured superstep copies nothing in)."""
    nl, p = out.shape[:2]
    dev = out.device
    if plan.route is None:
        return torch.ones((nl, p), dtype=torch.bool, device=dev)
    recv, send = plan.route
    rmask = inner.home_rows(nl, device=dev) == recv
    if plan.mode == "drop":
        return rmask[:, None].expand(nl, p)
    cmask = torch.arange(p, device=dev) == send
    return rmask[:, None] & cmask[None, :]


def _apply_fault(out: torch.Tensor, plan: FaultPlan, inner: Exchange, *,
                 salt: int) -> torch.Tensor:
    m = _block_mask(out, plan, inner)
    m = m.reshape(tuple(m.shape) + (1,) * (out.dim() - 2))
    if plan.mode in ("zero", "drop"):
        return torch.where(m, torch.zeros_like(out), out)
    if plan.mode == "misroute":
        # the block that should have come from sender q carries sender
        # q-1's payload: a switch delivering to the wrong port
        return torch.where(m, torch.roll(out, 1, dims=1), out)
    return _flip_bits(out, m, plan.seed, salt)


def _flip_bits(out: torch.Tensor, m: torch.Tensor, seed: int,
               salt: int) -> torch.Tensor:
    """The reference's patterns bit for bit: one RandomState draw an event
    (pattern seeds from seed and call index)."""
    rng = np.random.RandomState((seed * 1000003 + salt) % (2 ** 31))
    if out.dtype == torch.bool:
        return torch.where(m, ~out, out)
    if out.dtype.is_floating_point:
        if out.element_size() == 4:
            pat = np.int32(rng.randint(1, 2 ** 18)) & _F32_FLIP | np.int32(16)
            bits = out.contiguous().view(torch.int32)
            return torch.where(m, (bits ^ int(pat)).view(out.dtype), out)
        # bf16 / fp8: low mantissa bits through the int view
        pat = int(rng.randint(1, 8))
        bits = out.contiguous().view(_INT_VIEW[out.element_size()])
        return torch.where(m, (bits ^ pat).view(out.dtype), out)
    # integers: XOR low bits (stays in range for packed wire dtypes)
    pat = int(np.asarray(rng.randint(1, 8)).astype(
        torch.empty((), dtype=out.dtype).numpy().dtype))
    return torch.where(m, out ^ pat, out)
