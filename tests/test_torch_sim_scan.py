"""sim_scan in the PyTorch port: the plain version against the JAX
package's oracle and its Pallas kernel (interpret mode) on the same
injected arrays, the batched form against single rows, the wrapper's
checks, and — on a GPU only — the CUDA kernel against the plain version.

Bounds are the reference's own for its kernel (``tests/test_kernels.py``):
rtol 1e-12, with atol 1e-18 on durations and 1e-14 on states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mpi_ops import _ar1_filter
from repro.kernels.sim_scan.kernel import _A_MIN
from repro.kernels.sim_scan.kernel import sim_durations_scan as jax_scan
from repro.kernels.sim_scan.ref import sim_durations_ref as jax_ref
from repro_torch.kernels.sim_scan import sim_durations_ref, sim_durations_scan
from repro_torch.kernels.sim_scan.ref import ITEMS, THREADS, carry_chain, tile_maps

MIX = dict(tail_prob=0.08, tail_shift=0.35, spike_prob=0.003, spike_scale=8.0)


def _inputs(R, n, seed):
    rng = np.random.default_rng(seed)
    return dict(eps=rng.normal(0.0, 0.04, (R, n)), u_tail=rng.random((R, n)),
                u_mag=rng.random((R, n)), u_spike=rng.random((R, n)),
                state=rng.normal(0.0, 0.1, R), t0=rng.uniform(1e-5, 3e-5, R))


def _torch_call(fn, x, coeff, **kw):
    T = {k: torch.from_numpy(v) for k, v in x.items()}
    return fn(T["eps"], T["u_tail"], T["u_mag"], T["u_spike"], coeff=coeff,
              state=T["state"], t0=T["t0"], **MIX, **kw)


@pytest.mark.parametrize("coeff", [0.35, 0.0, -0.5, 0.9, 0.004])
@pytest.mark.parametrize("n", [32, 1000])
def test_plain_matches_jax_oracle_and_pallas_kernel(coeff, n):
    """Against the oracle on the whole grid; against the Pallas kernel
    where that kernel is exact. Below ``|coeff| = _A_MIN`` (0.005) it
    switches to a first-order form that is ~4e-6 off its own oracle at
    coeff 0.004 (ROADMAP Queue 3); the port has no such switch."""
    x = _inputs(1, n, seed=n + int(abs(coeff) * 1000))
    t, s = _torch_call(sim_durations_ref, x, coeff)
    kw = dict(coeff=coeff, state=float(x["state"][0]), t0=float(x["t0"][0]),
              **MIX)
    with jax.enable_x64(True):
        rows = [jnp.asarray(x[k][0])
                for k in ("eps", "u_tail", "u_mag", "u_spike")]
        outs = [jax_ref(*rows, **kw)]
        if abs(coeff) == 0.0 or abs(coeff) >= _A_MIN:
            outs.append(jax_scan(*rows, **kw, interpret=True))
        outs = [(np.asarray(jt), np.asarray(js)) for jt, js in outs]
    for jt, js in outs:
        np.testing.assert_allclose(t[0].numpy(), jt, rtol=1e-12, atol=1e-18)
        np.testing.assert_allclose(s[0].numpy(), js, rtol=1e-12, atol=1e-14)


def test_plain_matches_numpy_ar1_filter():
    rng = np.random.default_rng(7)
    eps = rng.normal(0.0, 0.04, size=500)
    zeros = torch.zeros(1, 500, dtype=torch.float64)
    _, s = sim_durations_ref(torch.from_numpy(eps)[None], zeros, zeros, zeros,
                             coeff=0.35,
                             state=torch.tensor([0.7], dtype=torch.float64),
                             t0=torch.ones(1, dtype=torch.float64),
                             tail_prob=0.0, tail_shift=0.0, spike_prob=0.0,
                             spike_scale=1.0)
    np.testing.assert_allclose(s[0].numpy(), _ar1_filter(eps, 0.35, 0.7),
                               rtol=1e-10, atol=1e-14)


def test_batched_rows_equal_single_rows():
    """Rows are independent: a batch of R=3 (what the fused engine sends,
    one row per epoch) is bit-identical to three single-row calls. The
    length spans several kernel chunks with a ragged end."""
    x = _inputs(3, 2500, seed=3)
    t, s = _torch_call(sim_durations_ref, x, 0.35)
    for r in range(3):
        xr = {k: v[r:r + 1] for k, v in x.items()}
        tr, sr = _torch_call(sim_durations_ref, xr, 0.35)
        assert torch.equal(t[r], tr[0]) and torch.equal(s[r], sr[0])


@pytest.mark.parametrize("coeff", [0.35, -0.999])
def test_look_back_from_any_inclusive_tile_gives_the_serial_carry(coeff):
    """The kernel's look-back invariant, on the plain version's own tile
    maps: from the end state of any earlier tile ``k`` (or the row's state,
    ``k = -1``), applying the aggregates of tiles ``k+1 .. i-1`` one by one
    to the scalar gives tile ``i``'s carry-in bit for bit, because those
    are the serial chain's own multiplications and additions."""
    chunk = THREADS * ITEMS
    x = _inputs(3, 9 * chunk + 17, seed=11)
    eps, state = torch.from_numpy(x["eps"]), torch.from_numpy(x["state"])
    Ea, Eb = tile_maps(eps, coeff)
    assert Ea.shape == (3, 10, chunk)
    s = carry_chain(Ea, Eb, state)
    _, s_ref = sim_durations_ref(eps, *[torch.from_numpy(x[k]) for k in
                                        ("u_tail", "u_mag", "u_spike")],
                                 coeff=coeff, state=state,
                                 t0=torch.from_numpy(x["t0"]), **MIX)
    assert torch.equal(s.reshape(3, -1)[:, :eps.shape[1]], s_ref)
    inclusive = [state] + [s[:, m, -1] for m in range(Ea.shape[1])]
    for i in range(1, Ea.shape[1]):
        for k in range(-1, i):
            c = inclusive[k + 1]
            for m in range(k + 1, i):
                c = Ea[:, m, -1] * c + Eb[:, m, -1]
            assert torch.equal(c, inclusive[i]), (i, k)
    # composing the aggregates with each other first (what a look-back of
    # the textbook kind does) is another association order: near coeff -1,
    # where an aggregate's slope coeff**chunk stays away from 0, it rounds
    # differently, so its carry would depend on where the look-back stopped
    a, b = Ea[:, 1, -1], Eb[:, 1, -1]
    for m in range(2, Ea.shape[1]):
        a, b = Ea[:, m, -1] * a, Ea[:, m, -1] * b + Eb[:, m, -1]
    composed = a * inclusive[1] + b
    assert torch.allclose(composed, inclusive[-1], rtol=1e-12, atol=1e-14)
    assert torch.equal(composed, inclusive[-1]) == (coeff == 0.35)


def test_wrapper_runs_plain_version_on_cpu_and_checks_inputs():
    x = _inputs(2, 100, seed=5)
    launches = sim_durations_scan.launches
    t, s = _torch_call(sim_durations_scan, x, 0.35)
    tr, sr = _torch_call(sim_durations_ref, x, 0.35)
    assert torch.equal(t, tr) and torch.equal(s, sr)
    assert sim_durations_scan.launches == launches   # no kernel on the CPU

    eps = torch.zeros(2, 8, dtype=torch.float64)
    one = torch.zeros(2, dtype=torch.float64)
    kw = dict(coeff=0.3, state=one, t0=one, **MIX)
    with pytest.raises(TypeError, match="float64"):
        sim_durations_scan(eps.float(), eps, eps, eps, **kw)
    with pytest.raises(ValueError, match="shape"):
        sim_durations_scan(eps, eps[:, :4], eps, eps, **kw)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        sim_durations_scan(eps, eps, eps, eps, **{**kw, "state": one[:1]})
    meta = eps.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        sim_durations_scan(meta, meta, meta, meta,
                           **{**kw, "state": one.to("meta"),
                              "t0": one.to("meta")})


@pytest.mark.cuda
@pytest.mark.parametrize("coeff", [0.35, 0.0, -0.5, 0.9, 0.004, -0.999])
def test_cuda_kernel_matches_plain_version(coeff):
    """The Hopper kernel against the plain version on the card, on the
    grid of ``chip_smoke.py`` phase 3: one row, 30, and more rows than
    the card has SMs; lengths around one tile (``THREADS * ITEMS``) and
    the main path's 1e5. Two launches on the same inputs are equal bit
    for bit (the look-back's carries do not depend on timing). It needs
    a GPU and nvcc: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sim_scan CUDA kernel only runs "
                    "on the card (chip_smoke.py runs this check there)")
    chunk = THREADS * ITEMS
    for R in (1, 30, 200):
        for n in (32, 1000, chunk - 1, chunk, chunk + 1, 100_000):
            x = {k: torch.from_numpy(v).cuda()
                 for k, v in _inputs(R, n, seed=R + n).items()}
            kw = dict(coeff=coeff, state=x["state"], t0=x["t0"], **MIX)
            rows = [x[k] for k in ("eps", "u_tail", "u_mag", "u_spike")]
            launches = sim_durations_scan.launches
            t, s = sim_durations_scan(*rows, **kw)
            t2, s2 = sim_durations_scan(*rows, **kw)
            torch.cuda.synchronize()
            assert sim_durations_scan.launches == launches + 2
            assert torch.equal(t, t2) and torch.equal(s, s2), (R, n)
            tr, sr = sim_durations_ref(*rows, **kw)
            torch.testing.assert_close(t, tr, rtol=1e-12, atol=1e-18)
            torch.testing.assert_close(s, sr, rtol=1e-12, atol=1e-14)
