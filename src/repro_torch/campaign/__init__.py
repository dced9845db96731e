"""repro_torch.campaign — the measurement backend on the device, the
persistent result store, and the resumable campaign orchestrator. ::

    from repro_torch.campaign import Campaign, CampaignSpec, TorchSimBackend
    from repro_torch.core import ExperimentDesign, TestCase

    spec = CampaignSpec([TestCase("allreduce", 4096)],
                        ExperimentDesign(n_launch_epochs=10, nrep=100))
    res = Campaign(spec, TorchSimBackend(p=16)).run()       # on the GPU
    res = Campaign(spec, TorchSimBackend(p=16, device="cpu")).run()

:class:`TorchKernelBackend` runs the same method against the hand-written
kernels and their plain versions (the kernel A/B path);
:class:`FunctionBackend` wraps any ``(epoch_factory, measure)`` pair.
:class:`SweepScheduler` compiles a factor grid into one campaign per cell
(:mod:`repro_torch.sweeps` reads which factors matter).
"""

from .backends import (FunctionBackend, MeasurementBackend, TorchKernelBackend,
                       TorchSimBackend)
from .core import Campaign, CampaignResult, CampaignSpec
from .store import SCHEMA_VERSION, ResultStore, StoreSnapshot
from .sweep import CellResult, SweepResult, SweepScheduler, SweepSpec

__all__ = [
    "MeasurementBackend",
    "TorchSimBackend",
    "TorchKernelBackend",
    "FunctionBackend",
    "Campaign",
    "CampaignResult",
    "CampaignSpec",
    "ResultStore",
    "StoreSnapshot",
    "SCHEMA_VERSION",
    "SweepSpec",
    "SweepScheduler",
    "SweepResult",
    "CellResult",
]
