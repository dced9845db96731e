"""Fused AR(1) duration sampling: the CUDA kernel and its plain version."""

from .kernel import sim_durations_scan
from .ref import sim_durations_ref

__all__ = ["sim_durations_scan", "sim_durations_ref"]
