"""Optimizers and distributed-optimization tricks: the port of the JAX
package's ``repro.optim``."""

from .adamw import OptimizerConfig, adamw_update, global_norm, init_opt_state, lr_at_step

__all__ = ["OptimizerConfig", "adamw_update", "init_opt_state", "lr_at_step",
           "global_norm"]
