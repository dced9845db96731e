"""Measuring real PyTorch computations with the paper's method (§6).

The port of the JAX package's ``repro.core.runtime_meter``. The object
under test is real work on a device (a hand-written kernel, its plain
version) rather than the simulator's cost model, and the same
experimental design applies:

  * a **launch epoch** is a fresh set of callables and input tensors.
    ``epoch_isolation``:
      - ``"clear_caches"``: the previous epoch's callables and their input
        tensors are dropped, then ``gc.collect()`` and
        ``torch.cuda.empty_cache()`` run, so each epoch allocates its
        buffers anew (the in-process analogue of a fresh launch). The
        loaded kernel libraries stay loaded: rebuilding them with ``nvcc``
        every epoch would measure the compiler, not the kernel;
      - ``"none"``: the callables of earlier epochs stay alive.
  * ``nrep`` timed calls per case, each fenced by
    ``torch.cuda.synchronize()`` on the device of the call's output (the
    counterpart of ``jax.block_until_ready``; host timestamps around a
    fenced call are the §3.2.1 local-times scheme). On the CPU eager
    PyTorch returns when the work is done, so the fence is a no-op there.
  * Tukey filtering and per-epoch averages downstream, through
    :mod:`repro_torch.core.design`.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["timed_calls", "TorchEpochContext", "make_torch_measure",
           "MeterConfig"]


def _fence(out: Any) -> None:
    """Wait for the device that holds ``out`` (a tensor or a tuple/list of
    them) to finish; nothing for results on the CPU."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for x in items:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            return


def timed_calls(fn: Callable[[], Any], nrep: int, warmup: int = 3) -> np.ndarray:
    """Time ``nrep`` calls of a nullary ``fn`` returning tensors, each call
    fenced on its output's device; ``warmup`` untimed calls first."""
    for _ in range(warmup):
        _fence(fn())
    out = np.empty(nrep)
    for i in range(nrep):
        t0 = time.perf_counter_ns()
        _fence(fn())
        out[i] = (time.perf_counter_ns() - t0) * 1e-9
    return out


@dataclass
class MeterConfig:
    warmup: int = 3
    epoch_isolation: str = "clear_caches"   # or "none"
    cold_buffers: bool = False               # §5.8 cache factor: fresh inputs per call


class TorchEpochContext:
    """Per-epoch context: builds (and owns) the epoch's callables.

    Warm-up is paid once per callable per epoch: adaptive-``nrep`` stopping
    asks for a sample in growing chunks, and re-warming every chunk would
    both waste wall-clock and re-measure the §5.8 cold-cache factor the
    epoch already amortized.

    ``previous`` is the context of the epoch before, which under
    ``"clear_caches"`` is released (callables and tensors dropped, caches
    emptied) before this epoch builds.
    """

    def __init__(self, build: Callable[[int], dict[str, Callable[[], Any]]],
                 epoch: int, config: MeterConfig,
                 previous: "TorchEpochContext | None" = None):
        if config.epoch_isolation not in ("clear_caches", "none"):
            raise ValueError(f"MeterConfig: epoch_isolation must be "
                             f"'clear_caches' or 'none', got "
                             f"{config.epoch_isolation!r}")
        self.epoch = epoch
        self.config = config
        if config.epoch_isolation == "clear_caches":
            if previous is not None:
                previous.release()
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
        self.callables = build(epoch)
        self._warmed: set[str] = set()

    def release(self) -> None:
        """Drop this epoch's callables and the tensors they hold."""
        self.callables.clear()
        self._warmed.clear()

    def measure(self, name: str, nrep: int) -> np.ndarray:
        fn = self.callables[name]
        warmup = 0 if name in self._warmed else self.config.warmup
        self._warmed.add(name)
        return timed_calls(fn, nrep, warmup=warmup)


def make_torch_measure(build: Callable[[int], dict[str, Callable[[], Any]]],
                       config: MeterConfig | None = None):
    """Adapters for a design's ``(epoch_factory, measure)`` pair.

    ``build(epoch)`` returns a dict mapping case names (``op@msize``) to
    nullary callables. Returns ``(epoch_factory, measure)``.
    """
    cfg = config or MeterConfig()
    last: list[TorchEpochContext] = []

    def epoch_factory(epoch: int) -> TorchEpochContext:
        ctx = TorchEpochContext(build, epoch, cfg,
                                previous=last.pop() if last else None)
        last.append(ctx)
        return ctx

    def measure(ctx: TorchEpochContext, case, nrep: int) -> np.ndarray:
        name = f"{case.op}@{case.msize}"
        if name not in ctx.callables and case.op in ctx.callables:
            name = case.op
        return ctx.measure(name, nrep)

    return epoch_factory, measure
