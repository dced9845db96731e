"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a hand-written CUDA kernel has no CPU mode, so these
skip (with the reason) where there is no GPU. This file imports neither
JAX nor the JAX package, so it also runs on a machine with a GPU and
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Bounds are the reference's own (``tests/test_kernels.py``): attention
within 2e-5 in f32 and 2e-2 in bf16; the SSD scan within 1e-5 of max|y|
in f32 and 3e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan


def _need_gpu(kernel: str) -> None:
    if not torch.cuda.is_available():
        pytest.skip(f"needs an NVIDIA GPU: the {kernel} CUDA kernel only runs "
                    "on the card (chip_smoke.py runs this check there too)")


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0.0, 1.0, s).astype(np.float32)) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(dtype):
    _need_gpu("flash_attention")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for (b, s, t, h, hkv, d), kw in (((2, 256, 256, 4, 2, 64), {}),
                                     ((1, 256, 256, 8, 4, 256), {}),
                                     ((1, 128, 128, 4, 2, 16), {}),
                                     ((2, 256, 256, 4, 2, 64), dict(window=32)),
                                     ((1, 100, 77, 4, 1, 32), dict(causal=False)),
                                     ((2, 1, 300, 8, 4, 256), dict(q_offset=171, kv_len=172)),
                                     ((1, 128, 128, 4, 2, 64), dict(window=4, kv_len=32))):
        q, k, v = (x.to(dtype).cuda() for x in
                   _draw(s + d, (b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
        launches = flash_attention.launches
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == launches + 1
        ref = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        assert out[ref.float().abs().sum(-1) == 0].abs().sum() == 0   # masked rows 0


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    _need_gpu("flash_attention")
    q, k, v = (x.cuda() for x in _draw(0, (1, 64, 2, 48), (1, 64, 2, 48), (1, 64, 2, 48)))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)
    q, k, v = (x.double().cuda() for x in _draw(0, (1, 64, 2, 32), (1, 64, 2, 32),
                                                (1, 64, 2, 32)))
    with pytest.raises(TypeError):
        flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(dtype):
    _need_gpu("ssd_scan")
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    for b, s, h, p, n, chunk in ((2, 128, 8, 16, 32, 32), (1, 256, 16, 32, 64, 64),
                                 (2, 256, 8, 64, 128, 128), (1, 200, 4, 64, 128, 64)):
        x, dta, B, C = (t.cuda() for t in _draw(s + p, (b, s, h, p), (b, s, h),
                                                  (b, s, n), (b, s, n)))
        dta = -dta.abs() * 0.1
        x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
        launches = ssd_scan.launches
        y = ssd_scan(x, dta, B, C, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == launches + 1
        yr = ssd_chunked(x, dta, B, C, chunk)[0]
        err = ((y.float() - yr.float()).abs().max() / yr.float().abs().max()).item()
        assert err < bound, (b, s, h, p, n, chunk, err)
