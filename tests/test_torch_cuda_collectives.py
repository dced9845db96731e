"""Real collectives on the card, through ``TorchCollectiveBackend``.

Marked ``cuda`` and skipped (with the reason) where there is no GPU. This
file imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_collectives.py

NCCL at world size 1 and gloo with CUDA tensors on four ranks that share
one card hold every op exactly against ``expected_collective`` (the ranks
hold each case when it is built; the outputs are held again here). NCCL
across ranks needs one GPU per rank and skips, with the reason, below
two.
"""

import numpy as np
import pytest
import torch

from repro_torch.campaign import TorchCollectiveBackend
from repro_torch.campaign.ranks import expected_collective
from repro_torch.core import TestCase
from repro_torch.core.runtime_meter import MeterConfig

OPS = ("psum", "all_gather", "all_to_all")


def _need_gpus(n: int, what: str) -> None:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s), {have} here: {what} "
                    "(chip_smoke.py phase 21 runs this check there too)")


def _hold_every_op(backend, cases) -> None:
    ctx = backend.make_epoch(0)
    dt = getattr(torch, backend.dtype)
    for case in cases:
        outs = backend.outputs(ctx, case)
        for rank, got in enumerate(outs):
            for (op, count, tn), out in zip(backend._build_case(case.op, case.msize), got):
                if rank >= tn:
                    assert out is None
                    continue
                want = expected_collective(op, rank, tn, count, dt).float().numpy()
                np.testing.assert_array_equal(out, want)        # exact
        times = backend.measure(ctx, case, 5)
        assert times.shape == (5,) and np.all(times > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nccl_world_one_holds_every_op(dtype):
    _need_gpus(1, "NCCL collectives on the card")
    with TorchCollectiveBackend(n_ranks=1, dist_backend="nccl", dtype=dtype,
                                meter=MeterConfig(epoch_isolation="none")) as b:
        _hold_every_op(b, [TestCase(op, m) for op in OPS for m in (1 << 10, 1 << 20)])


@pytest.mark.cuda
def test_gloo_four_ranks_on_one_card_hold_every_op():
    _need_gpus(1, "gloo with CUDA tensors")
    with TorchCollectiveBackend(n_ranks=4, dist_backend="gloo",
                                meter=MeterConfig(epoch_isolation="none")) as b:
        _hold_every_op(b, [TestCase(op, m) for op in OPS for m in (1 << 10, 1 << 16)]
                       + [TestCase("psum+all_gather", 1 << 10),
                          TestCase("psum@half", 1 << 10)])


@pytest.mark.cuda
def test_nccl_across_ranks_holds_every_op():
    _need_gpus(2, "NCCL refuses two ranks on one device")
    n = torch.cuda.device_count()
    with TorchCollectiveBackend(n_ranks=n, dist_backend="nccl",
                                meter=MeterConfig(epoch_isolation="none")) as b:
        _hold_every_op(b, [TestCase(op, 1 << 16) for op in OPS]
                       + [TestCase("psum@half", 1 << 16)])
