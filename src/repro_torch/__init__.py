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

The barrier scheme, the paper's comparator for windows (§4.6, Figs. 11-12),
is :func:`~repro_torch.core.run_barrier_timed`: the barrier loop on the
host, the operation's durations drawn on the device through ``sim_scan``.
Random-walk clocks (``ClockParams(rw_sigma=...)``) run on both paths.

Over the simulated campaign sit the paper's products, each a copy of the
reference's layer: factor sweeps (:class:`~repro_torch.campaign.SweepScheduler`,
:mod:`repro_torch.sweeps`, with racing allocation), the cross-run drift
audit (:mod:`repro_torch.history`) and the sim calibration fit
(:mod:`repro_torch.calibrate`); every cell, audited run and calibration
candidate samples through ``sim_scan``. The fault-tolerant sweep fleet
(:mod:`repro_torch.fleet`) runs a sweep's cells under leases, one worker
process per attempt forked from a fork server (a worker never inherits a
CUDA context), with seeded fault injection; its merged store equals the
serial run's record for record. The PGMPI guideline family
(``SIM_GUIDELINES``, :mod:`repro_torch.guidelines`) verifies the
simulated library through the same campaign.

The fourth path measures real collectives:
:class:`~repro_torch.campaign.TorchCollectiveBackend` (the port of
``JaxBackend``) runs ``psum``, ``all_gather`` and ``all_to_all`` on
``torch.distributed`` across a :class:`~repro_torch.campaign.RankGroup`
of rank processes, a fresh group each launch epoch, timed by a barrier
and the maximum over the ranks; :func:`~repro_torch.campaign.ensure_ranks`
refuses what cannot run (NCCL takes one rank per device). It is also the
real target of the sim calibration fit.
:class:`~repro_torch.campaign.FunctionBackend` lifts an
``(epoch_factory, measure)`` pair into the backend protocol.

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.
"""

from .campaign import (Campaign, CampaignResult, CampaignSpec, RankGroup,
                       ResultStore, TorchCollectiveBackend, TorchKernelBackend,
                       TorchSimBackend, ensure_ranks)
from .core import (BarrierRun, ExperimentDesign, TestCase, probe_barrier_skew,
                   run_barrier_timed, run_design)

__all__ = [
    "Campaign",
    "CampaignResult",
    "CampaignSpec",
    "ResultStore",
    "TorchSimBackend",
    "TorchKernelBackend",
    "TorchCollectiveBackend",
    "RankGroup",
    "ensure_ranks",
    "ExperimentDesign",
    "TestCase",
    "run_design",
    "run_barrier_timed",
    "probe_barrier_skew",
    "BarrierRun",
]
