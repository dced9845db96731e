"""Experimental-factor registry (§5.9, Table 4).

:class:`FactorSet` has the fields of the JAX package's
``repro.core.factors.FactorSet`` and the same fingerprint, so a store the
port writes is keyed, loaded and compared like one the reference writes.
:func:`capture_torch_factors` records the PyTorch environment: the JAX
fields stay empty, and the torch version, CUDA version, compute capability
and device name go in ``extra``.
"""

from __future__ import annotations

import hashlib
import json
import platform
from dataclasses import asdict, dataclass, field

import torch

__all__ = ["FactorSet", "capture_torch_factors"]


@dataclass(frozen=True)
class FactorSet:
    backend: str = "cpu"
    device_kind: str = "cpu"
    jax_version: str = ""
    mesh_shape: tuple = ()
    mesh_axes: tuple = ()
    sync_method: str = "barrier"
    window_size_us: float = 0.0
    n_launch_epochs: int = 1
    nrep: int = 0
    # adaptive-nrep stopping contract (0/0 = fixed nrep)
    nrep_min: int = 0
    nrep_max: int = 0
    rel_ci_target: float = 0.0
    # design identity
    design_seed: int = 0
    shuffle: bool = True
    measurement_backend: str = ""      # sim | "" (ad hoc)
    epoch_isolation: str = "process"   # process | none
    xla_flags: str = ""
    matmul_precision: str = "default"
    donate_buffers: bool = False
    remat_policy: str = "none"
    buffer_policy: str = "warm"        # warm | cold (cache factor, §5.8)
    dtype: str = "float32"
    host: str = field(default_factory=platform.node)
    extra: tuple = ()

    def to_dict(self) -> dict:
        return asdict(self)

    def fingerprint(self, exclude: tuple[str, ...] = ()) -> str:
        d = {k: v for k, v in self.to_dict().items() if k not in exclude and k != "host"}
        blob = json.dumps(d, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def capture_torch_factors(device="cpu", **overrides) -> FactorSet:
    """A :class:`FactorSet` for work run by PyTorch on ``device``.

    Touches no JAX: ``jax_version`` and ``xla_flags`` are empty. ``extra``
    is ``overrides["extra"]`` followed by the torch version, the CUDA
    version torch was built with, and the device's compute capability and
    name (empty capability and ``"cpu"`` for the CPU).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        capability = f"{major}.{minor}"
        name = torch.cuda.get_device_name(dev)
    else:
        capability, name = "", dev.type
    env = (("torch", torch.__version__), ("cuda", torch.version.cuda or ""),
           ("capability", capability), ("device_name", name))
    base = dict(jax_version="", xla_flags="")
    base.update(overrides)
    base["extra"] = tuple(base.get("extra", ())) + env
    return FactorSet(**base)
