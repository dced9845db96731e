"""ssd_scan in the PyTorch port: the plain version (``ssd_chunked``)
against the JAX package's ``ssd_chunked`` and its Pallas kernel
(interpret mode) on the same numpy inputs, against the sequential
recurrence, and the wrapper's checks and its CPU route. (The CUDA
kernel's own test is in ``test_torch_cuda_kernels.py``.)

Bounds: y and the final state within 1e-5 of max|y| (resp. max|state|)
in f32 and 3e-2 in bf16, the reference's kernel bounds
(``tests/test_kernels.py``); the recurrence at its 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro.models.ssm import ssd_chunked as jax_ssd
from repro_torch.convert import tensors_from_reference
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

BOUND = {jnp.float32: 1e-5, jnp.bfloat16: 3e-2}


def _draw(seed, b, s, h, p, n, decay=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (b, s, h, p)).astype(np.float32)
    dta = (-np.abs(rng.normal(0.0, 1.0, (b, s, h))) * decay).astype(np.float32)
    B = rng.normal(0.0, 1.0, (b, s, n)).astype(np.float32)
    C = rng.normal(0.0, 1.0, (b, s, n)).astype(np.float32)
    return x, dta, B, C


def _both(arrays, jdtype):
    """x, B, C in ``jdtype`` and dta in f32, as JAX arrays and as tensors."""
    x, dta, B, C = arrays
    jx = [jnp.asarray(x, jdtype), jnp.asarray(dta), jnp.asarray(B, jdtype),
          jnp.asarray(C, jdtype)]
    return jx, tensors_from_reference([np.asarray(a) for a in jx], "cpu")


def _rel(a, ref) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-6))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 8, 16, 32, 32),
    (1, 256, 16, 32, 64, 64),
    (2, 256, 8, 64, 128, 128),     # mamba2-1.3b-like ratios
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_jax_ssd_chunked(b, s, h, p, n, chunk, dtype):
    jx, tx = _both(_draw(s + p, b, s, h, p, n), dtype)
    y, state = ssd_chunked(*tx, chunk)
    yj, sj = jax_ssd(*jx, chunk)
    assert y.dtype == tx[0].dtype and y.shape == (b, s, h, p)
    assert state.shape == (b, h, p, n)
    assert _rel(y, yj) < BOUND[dtype]
    assert _rel(state, sj) < BOUND[dtype]


@pytest.mark.parametrize("b,s,h,p,n,chunk,hg", [
    (2, 128, 8, 16, 32, 32, 4),
    (1, 256, 16, 32, 64, 64, 8),
])
def test_plain_matches_pallas_kernel(b, s, h, p, n, chunk, hg):
    jx, tx = _both(_draw(s * h, b, s, h, p, n), jnp.float32)
    y = ssd_scan(*tx, chunk=chunk, head_group=hg)       # CPU: the plain version
    yp = ssd_scan_fwd(*jx, chunk=chunk, head_group=hg, interpret=True)
    assert _rel(y, yp) < 1e-5


def test_plain_matches_sequential_recurrence():
    """The chunked algorithm equals the naive per-step recurrence."""
    b, s, h, p, n = 1, 64, 2, 8, 16
    x, dta, B, C = _draw(1, b, s, h, p, n, decay=0.2)
    y, final = ssd_chunked(*map(torch.from_numpy, (x, dta, B, C)), 16)
    state = np.zeros((b, h, p, n), np.float32)
    y_naive = np.zeros((b, s, h, p), np.float32)
    for t in range(s):
        state = state * np.exp(dta[:, t])[:, :, None, None] \
            + np.einsum("bhp,bn->bhpn", x[:, t], B[:, t])
        y_naive[:, t] = np.einsum("bhpn,bn->bhp", state, C[:, t])
    np.testing.assert_allclose(y.numpy(), y_naive, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), state, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,chunk,jax_chunk", [(100, 32, 20), (70, 64, 35)])
def test_ragged_sequence_matches_reference_at_a_dividing_chunk(s, chunk, jax_chunk):
    """A sequence that is not a multiple of the chunk is padded with zeros,
    which adds nothing and decays nothing: the result is the reference's at
    a chunk that divides the sequence."""
    jx, tx = _both(_draw(s, 2, s, 4, 16, 32), jnp.float32)
    y, state = ssd_chunked(*tx, chunk)
    yj, sj = jax_ssd(*jx, jax_chunk)
    assert y.shape == (2, s, 4, 16)
    assert _rel(y, yj) < 1e-5 and _rel(state, sj) < 1e-5


def test_wrapper_runs_plain_version_on_cpu():
    x, dta, B, C = map(torch.from_numpy, _draw(2, 1, 128, 8, 16, 32))
    launches = ssd_scan.launches
    y = ssd_scan(x, dta, B, C, chunk=32, head_group=4)
    torch.testing.assert_close(y, ssd_chunked(x, dta, B, C, 32)[0], rtol=0, atol=0)
    # head_group was a TPU tiling choice: no effect
    torch.testing.assert_close(ssd_scan(x, dta, B, C, chunk=32, head_group=1), y,
                               rtol=0, atol=0)
    # a chunk longer than the sequence is clamped to it
    torch.testing.assert_close(ssd_scan(x, dta, B, C, chunk=256),
                               ssd_chunked(x, dta, B, C, 128)[0], rtol=0, atol=0)
    assert ssd_scan.launches == launches           # no kernel on the CPU


@pytest.mark.parametrize("bad,err", [
    (lambda x, d, B, C: (x, d[:, :, :3], B, C), ValueError),   # dta heads
    (lambda x, d, B, C: (x, d, B, C[:, :, :8]), ValueError),   # B/C mismatch
    (lambda x, d, B, C: (x[0], d, B, C), ValueError),          # not 4-d
    (lambda x, d, B, C: tuple(t.to("meta") for t in (x, d, B, C)), ValueError),
])
def test_wrapper_refuses(bad, err):
    x, dta, B, C = map(torch.from_numpy, _draw(4, 1, 32, 4, 8, 16))
    with pytest.raises(err):
        ssd_scan(*bad(x, dta, B, C), chunk=16)
