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

The second path is the kernel A/B campaign:
``verify_guidelines(KERNEL_GUIDELINES, TorchKernelBackend(...))`` →
``Campaign.run`` → :class:`~repro_torch.campaign.TorchKernelBackend` →
:mod:`repro_torch.core.runtime_meter` → the hand-written Hopper kernels
``flash_attention`` and ``ssd_scan`` (:mod:`repro_torch.kernels.ops`),
each measured against its plain PyTorch version with the paper's method
(launch epochs, Wilcoxon, Holm).

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.
"""

from .campaign import (Campaign, CampaignResult, CampaignSpec, ResultStore,
                       TorchKernelBackend, TorchSimBackend)
from .core import ExperimentDesign, TestCase

__all__ = [
    "Campaign",
    "CampaignResult",
    "CampaignSpec",
    "ResultStore",
    "TorchSimBackend",
    "TorchKernelBackend",
    "ExperimentDesign",
    "TestCase",
]
