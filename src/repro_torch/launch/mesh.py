"""Production mesh construction, the card's record, and a fake world.

The port of the JAX package's ``repro.launch.mesh``. Meshes are built by
functions (never module-level constants), so importing this module opens
no process group. A mesh is a ``DeviceMesh`` of device type ``"cuda"``
over the current process group wherever torch was built with CUDA: its
device type decides which collectives DTensor issues (on a ``"cpu"`` mesh
it runs an all-to-all as an all-gather and a chunk), so the dry run
builds the card's type even on a host without a card.

One card cannot hold a 256-rank mesh, so multi-device layouts are checked
three ways: on a fake process group of 256 or 512 ranks
(:func:`fake_world`, nothing allocated, tensors on ``meta``), on a few
gloo ranks on the CPU, and on a 1x1 NCCL mesh on the card.
"""

from __future__ import annotations

import contextlib

__all__ = ["H100", "mesh_device_type", "make_production_mesh", "make_local_mesh",
           "fake_world"]


class H100:
    """One NVIDIA H100 SXM5 80GB, the card the port runs on.

    Dense rates (half the data sheet's with-sparsity figures) and memory
    from NVIDIA's *H100 Tensor Core GPU* datasheet (SXM5 column); the
    inter-node link from the DGX H100 system, whose eight GPUs have one
    ConnectX-7 400 Gb/s NIC each."""

    NAME = "NVIDIA H100 80GB HBM3"      # as nvidia-smi prints it
    PEAK_FLOPS_BF16 = 989.4e12          # dense bf16 tensor cores [FLOP/s]
    PEAK_FLOPS_TF32 = 494.7e12          # dense TF32 tensor cores [FLOP/s]
    PEAK_FLOPS_FP32 = 66.9e12           # f32 outside the tensor cores [FLOP/s]
    HBM_BW = 3.35e12                    # HBM3 [B/s]
    HBM_BYTES = 80e9                    # 80 GB
    NVLINK_BW = 900e9                   # NVLink 4 per GPU, both ways [B/s]
    NVLINK_BW_PER_DIRECTION = 450e9     # [B/s]
    NIC_BW = 50e9                       # 400 Gb/s per GPU between nodes [B/s]
    GPUS_PER_NODE = 8


def mesh_device_type() -> str:
    """The device type meshes are built with: ``"cuda"`` where torch was
    built with CUDA (a card need not be present: the dry run's fake world
    has none), else ``"cpu"``. On a CPU-only build DTensor's sharding
    propagation cannot run some ops' decompositions on fake CUDA tensors
    (``_softmax_backward_data`` in the train step), and on a ``"cpu"``
    mesh DTensor runs an all-to-all as an all-gather and a chunk, so the
    dry run's records say which type counted them."""
    import torch

    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ``("data", "model")`` (256 ranks) or 2x16x16 ``("pod", "data",
    "model")`` (512) over the current process group, of
    :func:`mesh_device_type`. Raises unless the world has exactly that many
    ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(f"make_production_mesh: the {'x'.join(map(str, shape))} "
                           f"mesh wants a world of {n} ranks, the process group has "
                           f"{world or 'none'}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_local_mesh(data: int | None = None, model: int = 1):
    """A ``(data, model)`` mesh over the ranks there are (1x1 on one card),
    on the CPU when the process group is gloo's, else on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if data is None:
        data = n // model
    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks that communicates nothing
    (PyTorch's ``fake`` backend), this process rank 0: DTensor on it
    carries shapes, placements and the collectives it would issue, and on
    ``meta`` tensors allocates nothing. Destroyed on exit. A process group
    is process-wide, so one is open at a time."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
