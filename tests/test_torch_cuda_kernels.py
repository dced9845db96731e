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


# ---- the tensor-core instances of flash_attention (wgmma_bf16, tf32x3) ----

def _instance_cases(d):
    """(label, (b, s, t, h, hkv), kwargs): ragged S and T (not multiples of
    128 or 64), GQA groups 1, 2 and 8, a window under one tile, decode,
    prefill at an offset, soft-cap and fully masked rows."""
    return [("causal ragged S=T=200, group 2", (2, 200, 200, 4, 2), {}),
            ("non-causal S=100 T=77, group 8", (1, 100, 77, 8, 1), dict(causal=False)),
            ("causal S=T=384, group 1", (1, 384, 384, 4, 4), {}),
            ("window 32 < one tile", (2, 256, 256, 4, 2), dict(window=32)),
            ("decode S=1 q_offset 171 kv_len 172", (2, 1, 300, 8, 4),
             dict(q_offset=171, kv_len=172)),
            ("prefill q_offset 100 kv_len 172", (1, 130, 256, 4, 2),
             dict(q_offset=100, kv_len=172)),
            ("soft-cap 30", (1, 256, 256, 4, 2), dict(logit_cap=30.0)),
            ("fully masked rows (window 4, kv_len 32)", (1, 192, 192, 4, 2),
             dict(window=4, kv_len=32)),
            ("every row masked (kv_len 0)", (1, 64, 64, 4, 1), dict(kv_len=0))]


def _dead_rows(s, t, q_offset=0, causal=True, window=None, kv_len=None, **_):
    qpos = torch.arange(s)[:, None] + q_offset
    kpos = torch.arange(t)[None, :]
    vis = torch.ones(s, t, dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= (qpos - kpos) < window
    if kv_len is not None:
        vis &= kpos < kv_len
    return vis, ~vis.any(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_wgmma_bf16_matches_plain_version(d):
    """bf16 at 2e-2 and RMS(err) <= 1e-2 RMS of the plain version run in
    f32 on the same bf16 values; the soft-cap case only against that f32
    run (the plain version, like the JAX oracle, rounds logits to bf16
    before the cap, the kernels keep them in f32); fully masked rows
    exactly 0; every call through the tensor-core instance."""
    _need_gpu("flash_attention")
    for label, (b, s, t, h, hkv), kw in _instance_cases(d):
        scale = 3.0 if "logit_cap" in kw else 1.0
        q, k, v = (x.to(torch.bfloat16).cuda() for x in
                   _draw(s + t + d, (b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
        q, k = (q.float() * scale).to(torch.bfloat16), (k.float() * scale).to(torch.bfloat16)
        before = dict(flash_attention.launches_by_instance)
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_instance["wgmma_bf16"] == before["wgmma_bf16"] + 1
        assert flash_attention.launches_by_instance["simt"] == before["simt"]
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        ref32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        if "logit_cap" not in kw:
            ref = flash_attention_ref(q, k, v, **kw)
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2,
                                       msg=f"{label} d={d}")
        torch.testing.assert_close(out.float(), ref32, rtol=2e-2, atol=2e-2,
                                   msg=f"{label} d={d} (plain version in f32)")
        rms = (out.float() - ref32).pow(2).mean().sqrt()
        assert rms <= 1e-2 * ref32.pow(2).mean().sqrt() + 1e-30, (label, d, rms.item())
        _, dead = _dead_rows(s, t, **kw)
        assert (out[:, dead.cuda()] == 0).all(), (label, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("probe", ["column", "row"])
def test_flash_attention_wgmma_bf16_layout_probes(d, probe):
    """q = k = 0, so every visible key has weight exactly 1 before the
    normaliser. With V[t, c] = c / 4 (exact in bf16) every output element
    is its column's c / 4; with V[t, c] = t mod 256 every output row is the
    mean of its visible keys' indices, to the bf16 rounding of the output.
    A swizzle, descriptor or transpose error in either product moves a
    column or a row, which a tolerance against random data can hide."""
    _need_gpu("flash_attention")
    b, s, t, h, hkv = 1, 300, 300, 4, 2
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(b, t, hkv, d, dtype=torch.bfloat16, device="cuda")
    if probe == "column":
        vals = (torch.arange(d, dtype=torch.float32) / 4).expand(t, d)
    else:
        vals = (torch.arange(t, dtype=torch.float32) % 256)[:, None].expand(t, d)
    v = vals[None, :, None, :].expand(b, t, hkv, d).to(torch.bfloat16).cuda().contiguous()
    for kw in ({}, dict(window=40), dict(causal=False)):
        out = flash_attention(q, k, v, **kw).float().cpu()
        vis, _ = _dead_rows(s, t, **kw)
        if probe == "column":
            want = (torch.arange(d, dtype=torch.float32) / 4).expand(b, s, h, d)
            assert torch.equal(out, want), (d, kw)
        else:
            idx = (torch.arange(t, dtype=torch.float64) % 256)
            mean = (vis.double() * idx).sum(1) / vis.double().sum(1)        # (s,)
            want = mean[None, :, None, None].expand(b, s, h, d).float()
            assert torch.allclose(out, want, rtol=2 ** -8, atol=0), (d, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_attention_tf32x3_matches_plain_version(d):
    """f32 through the 3xTF32 tensor-core instance at the reference's
    bounds (2e-5, 3e-5 with soft-cap) on the bf16 instance's grid; fully
    masked rows exactly 0; every call counted once, by that instance."""
    _need_gpu("flash_attention")
    for label, (b, s, t, h, hkv), kw in _instance_cases(d):
        scale = 3.0 if "logit_cap" in kw else 1.0
        tol = 3e-5 if "logit_cap" in kw else 2e-5
        q, k, v = (x.cuda() for x in
                   _draw(s + t + d, (b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
        q, k = q * scale, k * scale
        before = dict(flash_attention.launches_by_instance)
        launches = flash_attention.launches
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == launches + 1
        assert flash_attention.launches_by_instance == {
            **before, "tf32x3": before["tf32x3"] + 1}, (label, d)
        assert out.dtype == torch.float32 and out.shape == q.shape
        ref = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(out, ref, rtol=tol, atol=tol, msg=f"{label} d={d}")
        _, dead = _dead_rows(s, t, **kw)
        assert (out[:, dead.cuda()] == 0).all(), (label, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("probe", ["column", "row"])
def test_flash_attention_tf32x3_layout_probes(d, probe):
    """q = k = 0, so every visible key has weight exactly 1. V[t, c] = c / 4
    must give every output element its column's c / 4, and V[t, c] =
    t mod 256 every output row the mean of its visible keys' indices, both
    exactly: the values are exact in TF32, their sums in f32, and the
    kernel divides by the normaliser. A fragment, key-permutation or
    padding error moves a column or a row."""
    _need_gpu("flash_attention")
    b, s, t, h, hkv = 1, 300, 300, 4, 2
    q = torch.zeros(b, s, h, d, device="cuda")
    k = torch.zeros(b, t, hkv, d, device="cuda")
    if probe == "column":
        vals = (torch.arange(d, dtype=torch.float32) / 4).expand(t, d)
    else:
        vals = (torch.arange(t, dtype=torch.float32) % 256)[:, None].expand(t, d)
    v = vals[None, :, None, :].expand(b, t, hkv, d).cuda().contiguous()
    for kw in ({}, dict(window=40), dict(causal=False)):
        out = flash_attention(q, k, v, **kw).cpu()
        vis, _ = _dead_rows(s, t, **kw)
        if probe == "column":
            want = (torch.arange(d, dtype=torch.float32) / 4).expand(b, s, h, d)
        else:
            idx = (torch.arange(t, dtype=torch.float64) % 256)
            mean = (vis.double() * idx).sum(1) / vis.double().sum(1)        # (s,)
            want = mean[None, :, None, None].expand(b, s, h, d).float()
        assert torch.equal(out, want), (d, kw, (out - want).abs().max().item())


@pytest.mark.cuda
def test_flash_attention_dispatch_by_dtype_and_head_dim():
    """f32 at every head dim goes to the 3xTF32 tensor-core instance, bf16
    at 64-256 to the bf16 one, bf16 at 16 and 32 stays on the CUDA-core
    instance; a bf16 layout TMA cannot read raises."""
    _need_gpu("flash_attention")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64, 128, 256):
            q, k, v = (x.to(dtype).cuda() for x in
                       _draw(d, (1, 70, 2, d), (1, 70, 2, d), (1, 70, 2, d)))
            before = dict(flash_attention.launches_by_instance)
            flash_attention(q, k, v)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                want = "tf32x3"
            else:
                want = "wgmma_bf16" if d >= 64 else "simt"
            assert flash_attention.launches_by_instance[want] == before[want] + 1
    q = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16, device="cuda")[..., :64]
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [8, 16, 24, 64])
def test_ssd_scan_kernel_p_tiles_and_ragged_chunks(dtype, p):
    """p not a multiple of the p-tile, a ragged last chunk, and results
    that do not depend on head_group."""
    _need_gpu("ssd_scan")
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    for b, s, h, n, chunk in ((2, 200, 4, 64, 64), (1, 130, 3, 32, 48)):
        x, dta, B, C = (t.cuda() for t in _draw(s * p, (b, s, h, p), (b, s, h),
                                                  (b, s, n), (b, s, n)))
        dta = -dta.abs() * 0.1
        x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
        launches = ssd_scan.launches
        y = ssd_scan(x, dta, B, C, chunk=chunk, head_group=1)
        torch.cuda.synchronize()
        assert ssd_scan.launches == launches + 1
        yr = ssd_chunked(x, dta, B, C, chunk)[0]
        err = ((y.float() - yr.float()).abs().max() / yr.float().abs().max()).item()
        assert err < bound, (b, s, h, p, n, chunk, err)
        assert torch.equal(y, ssd_scan(x, dta, B, C, chunk=chunk, head_group=h))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1024, 4096])
def test_ssd_scan_kernel_at_mamba2_widths(dtype, s):
    """mamba2-1.3b's SSD widths (64 heads, p 64, n 128, chunk 64)."""
    _need_gpu("ssd_scan")
    bound = 1e-5 if dtype == torch.float32 else 3e-2
    x, dta, B, C = (t.cuda() for t in _draw(s, (1, s, 64, 64), (1, s, 64),
                                              (1, s, 128), (1, s, 128)))
    dta = -dta.abs() * 0.1
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    y = ssd_scan(x, dta, B, C, chunk=64, head_group=8)
    yr = ssd_chunked(x, dta, B, C, 64)[0]
    err = ((y.float() - yr.float()).abs().max() / yr.float().abs().max()).item()
    assert err < bound, (s, dtype, err)
