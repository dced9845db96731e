"""Step functions (the port of ``repro.launch``'s ``steps.py``; abstract
input specs and the dry-run wait for later slices)."""

from .steps import init_train_state, make_decode_step, make_prefill_step, make_train_step

__all__ = ["init_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step"]
