"""Token data pipeline: deterministic synthetic corpus + prefetching loader.

The port of `repro/data/tokens.py` (numpy, copied).

Deterministic per (seed, step, host): a restarted/elastically-resized job
regenerates the exact same global batch for any step, which is what makes
checkpoint/restart exactly resumable without persisting a data cursor
(DESIGN.md §6).  Each host materialises only its shard of the global batch.

A real deployment swaps `SyntheticLM` for a tokenized-shard reader with the
same interface; the prefetcher (double buffering on a worker thread) is
shared.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Zipfian token stream with next-token labels (LM-loss-compatible)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, host_index: int = 0, host_count: int = 1,
                 context_tokens: int = 0, d_model: int = 0):
        assert global_batch % host_count == 0
        self.vocab = vocab
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host = host_index
        self.ctx = context_tokens
        self.d_model = d_model
        # Zipf-ish ranks: cheap approximation via exponential of uniforms
        self._alpha = 1.1

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        u = rng.random((self.local_batch, self.seq + 1))
        ranks = np.clip(u ** (-1.0 / (self._alpha - 1)) - 1, 0, self.vocab - 1)
        toks = ranks.astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.ctx:
            out["context"] = rng.standard_normal(
                (self.local_batch, self.ctx, self.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch (overlaps host datagen with step)."""

    def __init__(self, source, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(iter(source),),
                                        daemon=True)
        self._thread.start()

    def _work(self, it):
        while not self._stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                self._q.put(None)
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
