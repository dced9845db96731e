"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the JAX package's, on the CPU, on inputs drawn with numpy from a
seed: ``adamw_update`` on injected parameters, gradients and moments
(float32 within 1e-6 of max |ref|, bf16 parameters bit for bit),
``lr_at_step`` for the three schedules, ``global_norm``, int8
quantization and the compressed trees exactly, and the reference's
error-feedback test ported."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptimizerConfig as RefOptimizerConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import global_norm as ref_global_norm
from repro.optim import lr_at_step as ref_lr_at_step
from repro.optim.compress import compress_tree as ref_compress_tree
from repro.optim.compress import dequantize_int8 as ref_dequantize_int8
from repro.optim.compress import quantize_int8 as ref_quantize_int8
from repro_torch.optim import (OptimizerConfig, adamw_update, global_norm, init_opt_state,
                               lr_at_step)
from repro_torch.optim.compress import (compress_tree, decompress_tree, dequantize_int8,
                                        error_feedback_update, quantize_int8)

TOL = 1e-6
SHAPES = {"w": ((16, 32), np.float32), "emb": ((40, 8), "bfloat16"),
          "norm": ((8,), np.float32), "bias": ((24,), "bfloat16")}


def _to_jnp(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else dtype)


def _to_torch(a: jnp.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _inject(seed, grad_scale=0.05):
    """Parameters, gradients (in the parameters' types, as autograd and
    ``jax.grad`` give them) and moments after a few steps, as jnp arrays."""
    rng = np.random.default_rng(seed)
    params = {k: _to_jnp(rng.normal(0, 1, s), dt) for k, (s, dt) in SHAPES.items()}
    grads = {k: _to_jnp(rng.normal(0, grad_scale, s), dt) for k, (s, dt) in SHAPES.items()}
    m = {k: jnp.asarray(rng.normal(0, 0.01, s), jnp.float32) for k, (s, _) in SHAPES.items()}
    v = {k: jnp.asarray(rng.uniform(0, 1e-3, s), jnp.float32) for k, (s, _) in SHAPES.items()}
    return params, grads, {"m": m, "v": v, "count": jnp.asarray(3, jnp.int32)}


def _rel(port: torch.Tensor, ref) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(port.float().numpy() - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("clip", [1e9, 1.0, 0.0], ids=["unclipped", "clipped", "no-clip"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_update_matches_the_reference(clip, schedule):
    """Three AdamW steps from injected moments at count 3 (the cosine
    schedule past its warmup), weight decay on every leaf: the updated
    float32 parameters, both moments, the gradient norm and the learning
    rate within 1e-6 of max |ref|; bf16 parameters bit for bit where the
    clip scale is 1 (clipped, the two norms' float32 sums may round one
    ulp apart, so within 1e-6 of max |ref| too, which one bf16 ulp
    exceeds)."""
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=clip,
               weight_decay=0.1, schedule=schedule)
    rcfg, pcfg = RefOptimizerConfig(**cfg), OptimizerConfig(**cfg)
    params, grads, state = _inject(0)
    pparams = {k: _to_torch(a) for k, a in params.items()}
    pstate = {"m": {k: _to_torch(a) for k, a in state["m"].items()},
              "v": {k: _to_torch(a) for k, a in state["v"].items()},
              "count": torch.tensor(3, dtype=torch.int32)}
    for step in range(3):
        _, grads, _ = _inject(10 + step, grad_scale=0.05 * (step + 1))
        params, state, rmet = ref_adamw_update(params, grads, state, rcfg)
        out, pstate, pmet = adamw_update(pparams, {k: _to_torch(g) for k, g in grads.items()},
                                         pstate, pcfg)
        assert out is pparams
        assert pstate["count"].dtype == torch.int32 and int(pstate["count"]) == 4 + step
        assert _rel(pmet["grad_norm"], rmet["grad_norm"]) <= TOL
        assert _rel(pmet["lr"], rmet["lr"]) <= TOL
        for k, a in params.items():
            assert pparams[k].dtype == _to_torch(a).dtype, k
            if a.dtype == jnp.bfloat16 and clip != 1.0:
                assert torch.equal(pparams[k], _to_torch(a)), (step, k)
            assert _rel(pparams[k], a) <= TOL, (step, k)
            assert _rel(pstate["m"][k], state["m"][k]) <= TOL, (step, k)
            assert _rel(pstate["v"][k], state["v"][k]) <= TOL, (step, k)


def test_adamw_first_step_from_init_opt_state():
    """From ``init_opt_state``: zero f32 moments, count 0 -> 1, and the
    reference's first step (lr at step 1 of the warmup)."""
    params, grads, _ = _inject(3)
    rcfg, pcfg = RefOptimizerConfig(), OptimizerConfig()
    from repro.optim import init_opt_state as ref_init_opt_state

    rstate = ref_init_opt_state(params)
    pparams = {k: _to_torch(a) for k, a in params.items()}
    pstate = init_opt_state(pparams)
    assert all(m.dtype == torch.float32 and not m.any() for m in pstate["m"].values())
    assert pstate["count"].dtype == torch.int32 and int(pstate["count"]) == 0
    params, rstate, rmet = ref_adamw_update(params, grads, rstate, rcfg)
    _, pstate, pmet = adamw_update(pparams, {k: _to_torch(g) for k, g in grads.items()},
                                   pstate, pcfg)
    assert int(pstate["count"]) == 1
    assert _rel(pmet["lr"], rmet["lr"]) <= TOL
    for k, a in params.items():
        assert _rel(pparams[k], a) <= TOL, k
        if a.dtype == jnp.bfloat16:
            assert torch.equal(pparams[k], _to_torch(a)), k


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_step_matches_the_reference(schedule):
    cfg = dict(lr=3e-4, warmup_steps=100, decay_steps=1000, min_lr_ratio=0.1,
               schedule=schedule)
    steps = np.array([0, 1, 7, 50, 99, 100, 101, 333, 550, 999, 1000, 1001, 5000])
    ref = np.array([float(ref_lr_at_step(RefOptimizerConfig(**cfg), jnp.asarray(s, jnp.int32)))
                    for s in steps])
    port = np.array([float(lr_at_step(OptimizerConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
                     for s in steps])
    assert lr_at_step(OptimizerConfig(**cfg), 5).dtype == torch.float32
    np.testing.assert_allclose(port, ref, rtol=TOL, atol=0)


def test_global_norm_matches_the_reference():
    _, grads, _ = _inject(5)
    assert _rel(global_norm({k: _to_torch(g) for k, g in grads.items()}),
                ref_global_norm(grads)) <= TOL


@pytest.mark.parametrize("shape", [(64, 64), (1000,), (3, 5, 7), (256,), (1,)])
def test_quantize_int8_equals_the_reference(shape):
    """q and scale exactly (both round half to even), dequantized exactly;
    an all-zero block takes scale 1, as in the reference."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(0, 0.01, shape).astype(np.float32)
    if x.size > 256:
        x.reshape(-1)[:256] = 0.0          # one all-zero block
    rq, rs = ref_quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(dequantize_int8(q, s, shape).numpy(),
                                  np.asarray(ref_dequantize_int8(rq, rs, shape)))


def test_compress_tree_equals_the_reference():
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(0, 1, (300,)).astype(np.float32),
            "b": {"c": rng.normal(0, 1e-3, (17, 19)).astype(np.float32)}}
    ref = ref_compress_tree({"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(tree["b"]["c"])}})
    port = compress_tree({"a": torch.from_numpy(tree["a"]),
                          "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    for (q, s), (rq, rs) in ((port["a"], ref["a"]), (port["b"]["c"], ref["b"]["c"])):
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    like = {"a": torch.zeros(300), "b": {"c": torch.zeros(17, 19, dtype=torch.bfloat16)}}
    back = decompress_tree(port, like)
    assert back["b"]["c"].dtype == torch.bfloat16 and back["b"]["c"].shape == (17, 19)


def test_grad_compression_error_feedback():
    """The reference's ``tests/test_runtime.py::test_grad_compression_error_feedback``
    on the port: int8 compression has bounded per-step error; error
    feedback keeps the *accumulated* signal unbiased (the residual stays
    bounded)."""
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.normal(0, 0.01, (64, 64)).astype(np.float32))}
    q, scale = quantize_int8(g["w"])
    deq = dequantize_int8(q, scale, g["w"].shape)
    rel = float((deq - g["w"]).abs().max()) / float(g["w"].abs().max())
    assert rel < 0.02

    residual = None
    total_true = torch.zeros((8, 8))
    total_sent = torch.zeros((8, 8))
    for _ in range(30):
        g = {"w": torch.from_numpy(rng.normal(0, 0.01, (8, 8)).astype(np.float32))}
        comp, decomp, residual = error_feedback_update(g, residual)
        total_true = total_true + g["w"]
        total_sent = total_sent + decomp["w"]
    err = float((total_sent - total_true).abs().max())
    res = float(residual["w"].abs().max())
    assert err <= res + 1e-6   # the only gap is the current residual
    assert res < 0.01
