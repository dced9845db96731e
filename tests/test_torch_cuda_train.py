"""The training slice's checks that need the card.

Marked ``cuda`` and skipped (with the reason) where there is no GPU. Like
``test_torch_cuda_kernels.py`` this file imports neither JAX nor the JAX
package, so it runs on a machine with a GPU and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py \\
        tests/test_torch_cuda_train.py

The flash and SSD wrappers refuse a call autograd would want a gradient
from; the flash kernels run head dims 112 and 192 zero-padded and equal
their plain version there (the reference's bounds: 2e-5 in f32, 2e-2 in
bf16); one train step of a smoke model on the card equals the CPU's
within 1e-4 of max |CPU| per leaf, with TF32 off.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.ssd_scan import ssd_scan


def _need_gpu(what: str) -> None:
    if not torch.cuda.is_available():
        pytest.skip(f"needs an NVIDIA GPU: {what} runs only on the card "
                    "(chip_smoke.py runs this check there too)")


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0.0, 1.0, s).astype(np.float32)) for s in shapes]


@pytest.mark.cuda
def test_kernels_refuse_a_gradient():
    """Each wrapper raises on CUDA tensors when grad mode is on and an
    input requires grad, and runs under ``no_grad``/``inference_mode``."""
    _need_gpu("the flash and SSD kernels")
    q, k, v = (x.cuda().requires_grad_() for x in _draw(0, (1, 64, 4, 64), (1, 64, 2, 64),
                                                        (1, 64, 2, 64)))
    with pytest.raises(RuntimeError, match="no backward pass"):
        flash_attention(q, k, v)
    with torch.no_grad():
        flash_attention(q, k, v)
    x, dta, B, C = (t.cuda() for t in _draw(1, (1, 64, 4, 16), (1, 64, 4), (1, 64, 16),
                                             (1, 64, 16)))
    dta = -dta.abs()
    with pytest.raises(RuntimeError, match="no backward pass"):
        ssd_scan(x.requires_grad_(), dta, B, C, chunk=32)
    with torch.inference_mode():
        ssd_scan(x, dta, B, C, chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(32, 32, 112), (16, 16, 192)], ids=["zamba2", "mla"])
def test_padded_head_dims_match_plain_version(dtype, h, hkv, d):
    """zamba2-7b's attention width (D 112) and deepseek-v2's MLA (D 192)
    with fewer heads: causal, windowed and decode calls, each a padded
    launch, against the plain version."""
    _need_gpu("the flash kernels")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for (s, t), kw in (((300, 300), {}), ((300, 300), dict(window=64)),
                       ((1, 500), dict(q_offset=400, kv_len=401))):
        q, k, v = (x.to(dtype).cuda() for x in
                   _draw(s + d, (1, s, h, d), (1, t, hkv, d), (1, t, hkv, d)))
        padded = flash_attention.launches_padded
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches_padded == padded + 1
        assert out.shape == q.shape
        ref = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_smoke_train_step_card_equals_cpu():
    """Two train steps of gemma2's smoke model (``impl="ref"``, remat on)
    from the same weights on the card and the CPU, TF32 off: the loss, the
    gradient norm and every updated weight within 1e-4 of max |CPU|."""
    _need_gpu("the train step on the card")
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import init_train_state, make_train_step
    from repro_torch.models import init_params
    from repro_torch.runtime.trainer import to_device

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = get_smoke("gemma2-2b")
        cpu = init_train_state(init_params(cfg, device="cpu", seed=0))
        card = init_train_state(copy.deepcopy(cpu["params"]).to("cuda"))
        step = make_train_step(cfg)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2))
        for i in range(2):
            batch = data.batch_at(i)
            cpu, mc = step(cpu, to_device(batch, "cpu"))
            card, mg = step(card, to_device(batch, "cuda"))
            for key in ("loss", "grad_norm"):
                assert abs(mg[key].item() - mc[key].item()) <= 1e-4 * abs(mc[key].item()), key
        for (name, p), q in zip(cpu["params"].named_parameters(), card["params"].parameters()):
            err = (q.detach().cpu() - p.detach()).abs().max() / p.detach().abs().max().clamp_min(1e-30)
            assert err <= 1e-4, (name, float(err))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
