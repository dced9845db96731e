"""flash_attention in the PyTorch port: the plain version against the JAX
package's oracle ``flash_attention_ref`` and its Pallas kernel (interpret
mode) on the same numpy inputs, and the wrapper's checks and its CPU
route. (The CUDA kernel's own test is in ``test_torch_cuda_kernels.py``.)

Bounds are the reference's own (``tests/test_kernels.py``): 2e-5 in f32,
3e-5 with soft-cap, 2e-2 in bf16.

The Pallas kernel masks with a finite ``-1e30``, so on a row with no
visible key ``exp(s - m) = 1`` for every key and the row comes out as the
mean of v, not 0 as its docstring and its oracle say. The port follows the
oracle; it is compared with the Pallas kernel on the rows that have a
visible key, and the discrepancy on the others is asserted as a finding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.convert import tensors_from_reference
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def _draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, scale, s).astype(np.float32) for s in shapes]


def _both(arrays, jdtype):
    """The same values as JAX arrays and as port tensors."""
    jx = [jnp.asarray(a, jdtype) for a in arrays]
    return jx, tensors_from_reference([np.asarray(a) for a in jx], "cpu")


def _assert_close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _visible(s, t, q_offset=0, causal=True, window=None, kv_len=None,
             logit_cap=0.0):
    qpos = np.arange(s)[:, None] + q_offset
    kpos = np.arange(t)[None, :]
    vis = np.ones((s, t), bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= (qpos - kpos) < window
    if kv_len is not None:
        vis &= kpos < kv_len
    return vis.any(axis=1)


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 4, 2, 64),    # GQA
    (1, 512, 8, 1, 64),    # MQA
    (2, 128, 4, 4, 128),   # MHA
    (1, 256, 8, 2, 32),
    (1, 128, 8, 4, 256),   # gemma2-2b head dim and grouping
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_jax_oracle_shapes_dtypes(b, s, h, hkv, d, dtype):
    arrays = _draw(s + d, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    jx, tx = _both(arrays, dtype)
    out = flash_attention_ref(*tx)
    assert out.dtype == tx[0].dtype and out.shape == (b, s, h, d)
    _assert_close(out, jax_ref(*jx), TOL[dtype])


@pytest.mark.parametrize("kw,tol,scale", [
    (dict(window=32), 2e-5, 1.0),             # mixtral SWA / gemma local
    (dict(window=128), 2e-5, 1.0),
    (dict(logit_cap=30.0), 3e-5, 3.0),        # gemma-2 soft-cap
    (dict(causal=False), 2e-5, 1.0),
    (dict(window=4, kv_len=32), 2e-5, 1.0),   # fully masked rows
    (dict(kv_len=0), 2e-5, 1.0),              # every row fully masked
])
def test_plain_matches_jax_oracle_masks(kw, tol, scale):
    arrays = _draw(7, (2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    arrays[0] *= scale
    arrays[1] *= scale
    jx, tx = _both(arrays, jnp.float32)
    out = flash_attention_ref(*tx, **kw)
    ref = jax_ref(*jx, **kw)
    _assert_close(out, ref, tol)
    dead = ~_visible(128, 128, **kw)
    assert (out[:, dead] == 0).all() and (np.asarray(ref)[:, dead] == 0).all()


@pytest.mark.parametrize("s,q_offset,kv_len", [(128, 100, 172), (1, 171, 172)])
def test_plain_matches_jax_oracle_decode(s, q_offset, kv_len):
    """Static decode: queries at an offset against a longer cache."""
    arrays = _draw(s, (2, s, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64))
    jx, tx = _both(arrays, jnp.float32)
    kw = dict(q_offset=q_offset, kv_len=kv_len)
    _assert_close(flash_attention_ref(*tx, **kw), jax_ref(*jx, **kw), 2e-5)


@pytest.mark.parametrize("kw", [dict(), dict(window=32),
                                dict(q_offset=100, kv_len=172),
                                dict(window=4, kv_len=32)])
def test_plain_matches_pallas_kernel_on_visible_rows(kw):
    """Against the Pallas kernel (interpret mode) on rows with a visible key;
    on the others the port and the oracle give 0 and the Pallas kernel the
    mean of v (its -1e30 mask never empties the normaliser)."""
    s, t = 128, 256 if "q_offset" in kw else 128
    q, k, v = _draw(11, (1, s, 4, 64), (1, t, 2, 64), (1, t, 2, 64))
    jx, tx = _both([q, k, v], jnp.float32)
    out = flash_attention_ref(*tx, **kw).numpy()
    tr = [jnp.transpose(a, (0, 2, 1, 3)) for a in jx]
    window = kw.get("window")
    pallas = flash_attention_fwd(
        *tr, None if window is None else jnp.asarray(window, jnp.int32),
        causal=True, q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"),
        block_q=64, block_k=64, interpret=True, use_window=window is not None)
    pallas = np.asarray(jnp.transpose(pallas, (0, 2, 1, 3)))
    live = _visible(s, t, **kw)
    np.testing.assert_allclose(out[:, live], pallas[:, live], rtol=2e-5, atol=2e-5)
    if not live.all():
        assert (out[:, ~live] == 0).all()
        v_mean = np.repeat(v.mean(axis=1), 2, axis=1)          # (1, H, D)
        np.testing.assert_allclose(pallas[:, ~live],
                                   np.broadcast_to(v_mean[:, None], pallas[:, ~live].shape),
                                   rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in
               _draw(3, (1, 96, 4, 32), (1, 96, 2, 32), (1, 96, 2, 32)))
    launches = flash_attention.launches
    for kw in (dict(), dict(window=16, logit_cap=20.0), dict(causal=False)):
        torch.testing.assert_close(flash_attention(q, k, v, **kw),
                                   flash_attention_ref(q, k, v, **kw),
                                   rtol=0, atol=0)
    # block sizes are the reference's tiling arguments: no effect
    torch.testing.assert_close(flash_attention(q, k, v, block_q=32, block_k=64),
                               flash_attention(q, k, v), rtol=0, atol=0)
    assert flash_attention.launches == launches     # no kernel on the CPU


@pytest.mark.parametrize("bad,err", [
    (lambda q, k, v: (q, k.double(), v), TypeError),          # mixed types
    (lambda q, k, v: (q, k[:, :, :1], v), ValueError),        # k/v mismatch
    (lambda q, k, v: (q[..., :16], k, v), ValueError),        # head dims
    (lambda q, k, v: (q[:, :, :3], k, v), ValueError),        # 3 heads over 2
    (lambda q, k, v: (q[0], k, v), ValueError),               # not 4-d
    (lambda q, k, v: (q.to("meta"), k.to("meta"), v.to("meta")), ValueError),
])
def test_wrapper_refuses(bad, err):
    q, k, v = (torch.from_numpy(a) for a in
               _draw(5, (1, 32, 4, 32), (1, 32, 2, 32), (1, 32, 2, 32)))
    with pytest.raises(err):
        flash_attention(*bad(q, k, v))
