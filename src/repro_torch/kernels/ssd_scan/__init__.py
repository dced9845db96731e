"""Mamba-2 SSD chunked scan: the CUDA kernel and its plain version."""

from .kernel import ssd_scan
from .ref import ssd_chunked

__all__ = ["ssd_scan", "ssd_chunked"]
