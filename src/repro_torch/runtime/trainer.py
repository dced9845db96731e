"""Fault-tolerant, instrumented training loop (runtime substrate).

The port of the JAX package's ``repro.runtime.trainer``. It combines the
substrates into the production training loop:

  * checkpoint/restart (async saves every ``save_every`` steps; restart
    resumes from the latest checkpoint, data position derived from the step
    — counter-based pipeline, nothing else to restore). A restore copies
    into the live weights, moments and count in place;
  * failure injection for tests/drills (``FailureInjector`` raises at a
    chosen step; the supervisor restarts the loop, which restores);
  * step-time measurement with the paper's methodology
    (:mod:`repro_torch.core`): per-step host timings ending in a device
    fence (reading the loss), Tukey-filtered summaries, and straggler
    detection via the trailing-window Tukey fences.

Weights are drawn from a ``torch.Generator`` on the trainer's device (the
card unless the caller passes ``device="cpu"``), seeded with
``TrainerConfig.seed``. The train step runs eagerly and updates the state
in place: there is no ``jit`` and nothing to donate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..checkpoint.store import CheckpointConfig, CheckpointStore
from ..convert import load_train_state, train_state_tree
from ..core.stats import tukey_fences, tukey_filter
from ..data.pipeline import DataConfig, Prefetcher, SyntheticLM
from ..launch.steps import init_train_state, make_train_step
from ..models import ModelConfig, init_params
from ..optim import OptimizerConfig

__all__ = ["TrainerConfig", "Trainer", "FailureInjector", "StragglerMonitor",
           "run_supervised"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    save_every: int = 20
    log_every: int = 10
    seed: int = 0
    remat: bool = True
    measure_steps: bool = True


class FailureInjector:
    """Deterministic failure drill: raises RuntimeError at given steps."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class StragglerMonitor:
    """Flags steps whose duration exceeds the Tukey fence of a trailing
    window — the runtime payoff of the paper's outlier methodology."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = np.array(self.times[-self.window:])
        if hist.size < 10:
            return False
        lo, hi = tukey_fences(hist[:-1])
        if dt > hi:
            self.flagged.append(step)
            return True
        return False


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy token ids) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


class Trainer:
    def __init__(self, model_cfg: ModelConfig, data_cfg: DataConfig,
                 opt_cfg: OptimizerConfig | None = None,
                 trainer_cfg: TrainerConfig | None = None,
                 ckpt_cfg: CheckpointConfig | None = None, *, device="cuda"):
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.cfg = trainer_cfg or TrainerConfig()
        self.store = CheckpointStore(ckpt_cfg or CheckpointConfig())
        self.device = torch.device(device)
        self.monitor = StragglerMonitor()
        self.step_times: list[float] = []
        self.losses: list[float] = []

    def _init_state(self) -> dict:
        model = init_params(self.model_cfg, device=self.device, seed=self.cfg.seed)
        return init_train_state(model)

    def run(self, failure: FailureInjector | None = None) -> dict:
        """One supervised attempt; raises on injected failure (the
        supervisor catches and re-invokes — see :func:`run_supervised`)."""
        state = self._init_state()
        self.store.wait()           # a save of a failed attempt may be in flight
        start_step = 0
        if self.store.latest_step() is not None:
            restored, start_step = self.store.restore(train_state_tree(state))
            load_train_state(state, restored)
        step_fn = make_train_step(self.model_cfg, self.opt_cfg, remat=self.cfg.remat)
        source = SyntheticLM(self.data_cfg)
        prefetch = Prefetcher(source, start_step=start_step)
        try:
            for step in range(start_step, self.cfg.total_steps):
                if failure is not None:
                    failure.check(step)
                got_step, batch = prefetch.next()
                if got_step != step:
                    raise RuntimeError(f"prefetcher gave step {got_step}, want {step}")
                batch = to_device(batch, self.device)
                t0 = time.perf_counter_ns()
                state, metrics = step_fn(state, batch)
                loss = metrics["loss"].item()        # fences the step
                dt = (time.perf_counter_ns() - t0) * 1e-9
                self.step_times.append(dt)
                self.losses.append(loss)
                self.monitor.observe(step, dt)
                if (step + 1) % self.cfg.save_every == 0 \
                        or step + 1 == self.cfg.total_steps:
                    self.store.save(step + 1, train_state_tree(state))
                if (step + 1) % self.cfg.log_every == 0:
                    print(f"[train] step {step + 1} loss {loss:.4f} "
                          f"dt {dt * 1e3:.1f}ms")
        finally:
            prefetch.close()
        self.store.wait()
        kept = tukey_filter(np.array(self.step_times)) if self.step_times else np.array([])
        return {
            "final_step": self.cfg.total_steps,
            "losses": self.losses,
            "mean_step_time": float(np.mean(kept)) if kept.size else 0.0,
            "stragglers": list(self.monitor.flagged),
            "state": state,
        }


def run_supervised(trainer: Trainer, failure: FailureInjector | None = None,
                   max_restarts: int = 3) -> dict:
    """The supervisor: restart-on-failure from the latest checkpoint."""
    attempts = 0
    while True:
        try:
            out = trainer.run(failure)
            out["restarts"] = attempts
            return out
        except RuntimeError as e:
            attempts += 1
            print(f"[supervisor] attempt {attempts} failed: {e}; restarting")
            if attempts > max_restarts:
                raise
