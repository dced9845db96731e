"""repro_torch — the simulated measurement campaign on PyTorch and CUDA.

The port of the JAX package ``repro`` to PyTorch, one slice at a time
(see ROADMAP.md). This slice is the paper's method on the simulator:
``Campaign.run`` → :class:`~repro_torch.campaign.TorchSimBackend` →
:mod:`repro_torch.simengine`, whose duration sampling runs the
hand-written Hopper kernel ``sim_scan``
(``kernels/sim_scan/csrc/sim_scan.cu``). The host side (simulated
cluster, clocks, sync algorithms, cost models, design, factors, store) is
numpy, copied from ``repro`` so that one seed draws the same host state in
both packages. This package imports neither JAX nor ``repro``.

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.
"""

from .campaign import (Campaign, CampaignResult, CampaignSpec, ResultStore,
                       TorchSimBackend)
from .core import ExperimentDesign, TestCase

__all__ = [
    "Campaign",
    "CampaignResult",
    "CampaignSpec",
    "ResultStore",
    "TorchSimBackend",
    "ExperimentDesign",
    "TestCase",
]
