"""The fault-tolerant training loop (the port of the JAX package's
``repro.runtime``)."""

from .trainer import FailureInjector, StragglerMonitor, Trainer, TrainerConfig, run_supervised

__all__ = ["TrainerConfig", "Trainer", "FailureInjector", "StragglerMonitor",
           "run_supervised"]
