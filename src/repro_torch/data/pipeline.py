"""Deterministic synthetic data pipeline with host sharding and prefetch.

Production layout: each host materializes only its shard of the global
batch (``host_index / host_count``), generated counter-based (stateless) so
restarts are exactly reproducible from the step number alone — the data
analogue of the paper's reproducibility requirement, and what makes
checkpoint/restart byte-identical.

A copy of the JAX package's ``repro.data.pipeline`` (numpy, so a batch is
the reference's bit for bit). Batches are numpy arrays on the host; moving
one to the device is the trainer's job.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 1234
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Markov-ish synthetic token stream (counter-based, stateless).

    ``batch_at(step)`` is a pure function of (config, step) — no iterator
    state to checkpoint. Labels are next-token shifted.
    """

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        b, s = self.local_batch, cfg.seq_len
        # structured stream: random walk over the vocab with resets, so the
        # model has something learnable (tests train loss down on this)
        start = rng.integers(0, cfg.vocab_size, size=(b, 1))
        steps = rng.integers(-3, 4, size=(b, s))
        toks = (start + np.cumsum(steps, axis=1)) % cfg.vocab_size
        toks = toks.astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return {"tokens": toks, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (compute/data overlap on the host)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
