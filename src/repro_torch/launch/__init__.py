"""Step functions of the serving path (the port of ``repro.launch``'s
``steps.py``; the train step, abstract input specs and the dry-run wait
for later slices)."""

from .steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
