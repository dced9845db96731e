"""The kernel wrappers' dispatch and layout checks, called directly on CPU
tensors: which flash-attention instance a CUDA call would launch, which
layouts the kernels refuse (they copy 16-byte pieces: TMA for the bf16
attention kernel, ``cp.async`` for the f32 attention kernel and the SSD
kernels), and how the SSD
chunk walk's p-tiles cover the head dim. No kernel runs here; the
kernels themselves are held against their plain versions on the card
(``test_torch_cuda_kernels.py``, ``chip_smoke.py``). Also the head-dim
padding of the CUDA route and the guard that refuses a gradient.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import needs_grad, refuse_grad
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS, WGMMA_HEAD_DIMS,
                                                        check_kernel_layout,
                                                        kernel_instance, pad_head_dim,
                                                        padded_head_dim)
from repro_torch.kernels.ssd_scan.kernel import P_TILE, p_tiles
from repro_torch.kernels.ssd_scan.kernel import check_kernel_layout as ssd_layout


def _qkv(dtype, d, pad=0, b=1, s=64, h=4, hkv=2):
    """q, k, v in model layout whose rows are ``pad`` elements longer than
    head_dim (a slice of a wider tensor)."""
    def one(heads):
        return torch.zeros(b, s, heads, d + pad, dtype=dtype)[..., :d]
    return one(h), one(hkv), one(hkv)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dispatch_table(dtype, d):
    if dtype == torch.float32:
        want = "tf32x3"
    else:
        want = "wgmma_bf16" if d in (64, 128, 256) else "simt"
    assert kernel_instance(dtype, d) == want
    assert check_kernel_layout(*_qkv(dtype, d)) == want


@pytest.mark.parametrize("d", WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("pad", [4, 12])
def test_flash_bf16_strides_not_multiple_of_8_raise(d, pad):
    with pytest.raises(ValueError, match="multiple of 8"):
        check_kernel_layout(*_qkv(torch.bfloat16, d, pad=pad))


@pytest.mark.parametrize("pad", [8, 64])
def test_flash_bf16_strides_multiple_of_8_pass(pad):
    assert check_kernel_layout(*_qkv(torch.bfloat16, 128, pad=pad)) == "wgmma_bf16"


def test_flash_f32_keeps_the_cuda_core_rule():
    """The f32 instance keeps the CUDA-core kernel's rule (it copies
    16-byte pieces with cp.async): a stride of 68 floats passes, 66 does
    not."""
    assert check_kernel_layout(*_qkv(torch.float32, 64, pad=4)) == "tf32x3"
    with pytest.raises(ValueError, match="multiple of 4"):
        check_kernel_layout(*_qkv(torch.float32, 64, pad=2))


def test_flash_unaligned_start_raises():
    base = torch.zeros(1, 64, 4, 64 + 8, dtype=torch.bfloat16)
    q = base[..., 4:68]                      # starts 8 bytes in
    k = v = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        check_kernel_layout(q, k, v)


def test_flash_f32_unaligned_start_raises():
    base = torch.zeros(1, 64, 4, 64 + 4, dtype=torch.float32)
    q = base[..., 2:66]                      # starts 8 bytes in
    k = v = torch.zeros(1, 64, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="cp.async"):
        check_kernel_layout(q, k, v)


def test_flash_length_one_dims_ignore_their_stride():
    """A dimension of length 1 is never stepped over: its stride, whatever
    torch reports, does not make a decode query unfit for TMA."""
    q = torch.zeros(1, 3, 8, 128, dtype=torch.bfloat16)[:, 1:2]   # S = 1
    q = q.as_strided(q.shape, (5, 3, 128, 1), q.storage_offset())
    k = v = torch.zeros(1, 300, 4, 128, dtype=torch.bfloat16)
    assert check_kernel_layout(q, k, v) == "wgmma_bf16"


def test_flash_other_types_raise():
    with pytest.raises(TypeError):
        check_kernel_layout(*_qkv(torch.float16, 64))


def _ssd(dtype, b=1, s=96, h=4, p=16, n=32, pad=0):
    x = torch.zeros(b, s, h, p + pad, dtype=dtype)[..., :p]
    dta = torch.zeros(b, s, h)
    B = torch.zeros(b, s, n, dtype=dtype)
    C = torch.zeros(b, s, n, dtype=dtype)
    return x, dta, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [8, 16, 24, 64])
def test_ssd_layout_passes_contiguous(dtype, p):
    ssd_layout(*_ssd(dtype, p=p))


@pytest.mark.parametrize("dtype,pad", [(torch.float32, 2), (torch.bfloat16, 4)])
def test_ssd_strides_not_multiple_of_16_bytes_raise(dtype, pad):
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_layout(*_ssd(dtype, p=16, pad=pad))


def test_ssd_unaligned_B_raises():
    x, dta, B, C = _ssd(torch.float32)
    B = torch.zeros(96 * 32 + 1)[1:].view(1, 96, 32)   # starts 4 bytes in
    with pytest.raises(ValueError, match="aligned"):
        ssd_layout(x, dta, B, C)


@pytest.mark.parametrize("p", [4, 8, 12, 16, 24, 48, 64, 80, 128, 256])
def test_ssd_p_tiles_cover_p_exactly(p):
    """Every head-dim column is in exactly one tile: the tiles
    [i * tile, min((i + 1) * tile, p)) are disjoint and their union is
    [0, p)."""
    tile, n_tiles = p_tiles(p)
    assert tile == P_TILE
    covered = [c for i in range(n_tiles) for c in range(i * tile, min((i + 1) * tile, p))]
    assert covered == list(range(p))
    assert (n_tiles - 1) * tile < p <= n_tiles * tile


@pytest.mark.parametrize("d,built", [(8, 16), (48, 64), (112, 128), (128, 128), (192, 256),
                                     (256, 256)])
def test_flash_head_dim_padding(d, built):
    """A head dim between the built ones runs at the next one up, q, k and
    v zero-padded (a fresh tensor, which passes every layout rule); on the
    CPU, pad -> plain version at the unpadded scale -> slice equals the
    plain version at D: in f32 within 1e-6 of max |out|, in bf16 at the
    reference's bf16 attention bound, 2e-2 (the logits are rounded to bf16,
    and a sum over more terms may round them otherwise)."""
    assert padded_head_dim(d) == built
    rng = np.random.default_rng(d)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 40, h, d)).astype(np.float32)).to(dtype)
                   for h in (4, 2, 2))
        qp, kp, vp = pad_head_dim(q, k, v)
        assert qp.shape == (1, 40, 4, built) and kp.shape == vp.shape == (1, 40, 2, built)
        assert not qp[..., d:].any() and torch.equal(qp[..., :d], q)
        check_kernel_layout(qp, kp, vp)
        kw = dict(window=16, logit_cap=50.0)
        want = flash_attention_ref(q, k, v, **kw)
        got = flash_attention_ref(qp, kp, vp, scale=1.0 / math.sqrt(d), **kw)[..., :d]
        assert torch.allclose(got.float(), want.float(), rtol=0, atol=tol * float(want.abs().max()))


def test_flash_head_dims_above_the_largest_raise():
    with pytest.raises(ValueError, match="head dims"):
        padded_head_dim(320)
    with pytest.raises(ValueError, match="head dims"):
        pad_head_dim(*_qkv(torch.float32, 320))


def test_grad_guard_predicate():
    """The guard the kernels run on CUDA tensors: a gradient is wanted when
    grad mode is on and an input requires grad, not otherwise."""
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not needs_grad(a, a)
    assert needs_grad(a, b)
    with torch.no_grad():
        assert not needs_grad(a, b)
    with torch.inference_mode():
        assert not needs_grad(a, a)
    with pytest.raises(RuntimeError, match="no backward pass.*impl=\"ref\""):
        refuse_grad("flash_attention", a, b)
    refuse_grad("flash_attention", a, b.detach())
