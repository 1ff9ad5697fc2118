"""Fault-tolerance runtime: straggler detection + preemption handling.

The port of `repro/train/fault.py` (pure Python, copied).

1000+-node posture (DESIGN.md §6):
  * StragglerDetector — per-step wall-time EWMA + z-score; in a multi-host
    deployment each host feeds its step time and the controller flags hosts
    whose times diverge (here: flags slow steps and surfaces a callback,
    which the launcher uses to log/alert; the rebalance hook is where a real
    deployment would shrink that host's microbatch share).
  * PreemptionGuard — SIGTERM/SIGINT => checkpoint-at-next-step-boundary,
    the standard TPU-pod eviction contract.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1          # EWMA weight
    z_threshold: float = 3.0
    warmup: int = 5
    # variance floor as a fraction of the mean: perfectly regular warmup
    # steps prime _var to ~0, and without a floor the first post-warmup
    # step with ANY jitter z-explodes and gets flagged (the §6 regression
    # tests/test_fault.py::test_straggler_warmup_jitter pins this).
    min_rel_std: float = 0.05
    on_straggler: Callable[[int, float, float], None] | None = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    events: int = 0

    def observe(self, step: int, seconds: float) -> bool:
        """Feed one step duration; returns True if flagged as straggling."""
        self._n += 1
        if self._n <= self.warmup:
            # prime the EWMA
            self._mean = seconds if self._n == 1 else (
                self._mean + (seconds - self._mean) / self._n)
            self._var = max(self._var, (seconds - self._mean) ** 2)
            return False
        std = max(self._var ** 0.5, self.min_rel_std * abs(self._mean), 1e-6)
        z = (seconds - self._mean) / std
        flagged = z > self.z_threshold
        if flagged:
            self.events += 1
            if self.on_straggler:
                self.on_straggler(step, seconds, self._mean)
        # update EWMA (skip flagged steps so stragglers don't poison the mean)
        if not flagged:
            d = seconds - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        return flagged


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a 'checkpoint and exit' flag checked at
    step boundaries (never mid-collective)."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._old = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._old[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # not on main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, old in self._old.items():
            signal.signal(sig, old)


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
