"""The true-time timelines of one round of HCA's tree: the CUDA kernel and
its plain version."""

from .kernel import hca_timeline
from .ref import hca_timeline_ref, row_edges, row_length

__all__ = ["hca_timeline", "hca_timeline_ref", "row_edges", "row_length"]
