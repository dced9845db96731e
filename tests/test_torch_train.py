"""The port's training path against the JAX package's, for all ten
``SMOKE`` configs, in f32 on the CPU.

Weights come from the reference's ``init_params`` and are carried by
``params_from_reference``; token ids and frontend embeddings are drawn
with numpy from a seed. Held against the reference at ``max |port - ref|
<= 1e-4 * max |ref|`` per leaf: the loss of ``loss_fn(..., impl="ref")``
and the gradient of every weight against ``jax.value_and_grad`` of the
reference's ``loss_fn``, with and without ``ce_chunk`` and with ``remat``
on and off (the reference's remat changes no value, so it runs without);
then one ``make_train_step`` step against the reference's on the same
state: every weight, both moments, the count and the metrics. Seamless's
encoder memory is an input of the loss in both packages, computed
without a gradient, so the encoder's weights get a zero gradient and
still decay.

The reference runs jitted, once per architecture in a module-scoped
fixture, at the depth cuts of ``test_torch_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.tuning as ref_tuning
import repro_torch.configs as port_configs
import repro_torch.models.tuning as tuning
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import OptimizerConfig as RefOptimizerConfig
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch.convert import (named_to_reference, params_from_reference,
                                 train_state_from_reference, train_state_to_reference)
from repro_torch.launch import make_train_step
from repro_torch.models import loss_fn
from repro_torch.models.lm import encode
from repro_torch.optim import OptimizerConfig

ARCHS = ref_configs.ARCHS
DEPTH = {"zamba2-7b": 3, "deepseek-v2-236b": 2}
TOL = 1e-4
B, S, CHUNK = 2, 16, 4
#: A first step at a learning rate that moves every weight visibly (weight
#: decay included); ``eps`` well above the gradients' rounding noise, so
#: that the first step's ``g / (|g| + eps)`` is no sign test where a
#: gradient is ~0 (``tests/test_torch_optim.py`` holds the update's
#: arithmetic at the default ``eps``).
OPT = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1, eps=1e-2)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    front = None
    if cfg.frontend:
        front = rng.normal(0.0, 1.0, (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, front


def _reference(cfg, params, batch):
    def grads(chunk):
        ref_tuning.set_tuning(ce_chunk=chunk)
        try:      # the knob is read while tracing: a fresh jit
            return jax.jit(jax.value_and_grad(
                lambda p: ref_models.loss_fn(cfg, p, batch, remat=False), has_aux=True))(params)
        finally:
            ref_tuning.reset_tuning()

    out = {chunk: grads(chunk) for chunk in (0, CHUNK)}
    state = {"params": params, "opt": ref_init_opt_state(params)}
    out["step"] = jax.jit(ref_make_train_step(cfg, RefOptimizerConfig(**OPT), remat=False))(
        state, batch)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    depth = {"n_layers": DEPTH[request.param]} if request.param in DEPTH else {}
    rcfg = ref_configs.get_smoke(request.param).scaled(**depth)
    pcfg = port_configs.get_smoke(request.param).scaled(**depth)
    toks, front = _inputs(pcfg)
    params = jax.jit(ref_models.init_params, static_argnums=0)(rcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    rbatch = {"tokens": jnp.asarray(toks), "labels": jnp.roll(jnp.asarray(toks), -1, axis=1)}
    pbatch = {"tokens": torch.from_numpy(toks).long()}
    pbatch["labels"] = torch.roll(pbatch["tokens"], -1, dims=1)
    if pcfg.frontend == "vision":
        rbatch["embeds"], pbatch["embeds"] = jnp.asarray(front), torch.from_numpy(front)
    if pcfg.frontend == "audio":
        rbatch["memory"] = ref_models.encode(rcfg, params, jnp.asarray(front))
        with torch.no_grad():
            pbatch["memory"] = encode(pcfg, params_from_reference(pcfg, tree, "cpu"),
                                      torch.from_numpy(front))
    return pcfg, tree, pbatch, _reference(rcfg, params, rbatch)


def rel_err(port, ref) -> float:
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _assert_trees(port, ref, what):
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r], what
    for (path, p), (_, r) in zip(flat_p, flat_r):
        assert rel_err(p, r) <= TOL, (what, jax.tree_util.keystr(path), rel_err(p, r))


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["full", "ce_chunk"])
def test_loss_and_gradient_of_every_weight(arch, chunk, remat):
    cfg, tree, batch, ref = arch
    model = params_from_reference(cfg, tree, "cpu").requires_grad_(True)
    tuning.set_tuning(ce_chunk=chunk)
    try:
        loss, metrics = loss_fn(cfg, model, batch, remat=remat, impl="ref")
    finally:
        tuning.reset_tuning()
    loss.backward()
    (ref_loss, ref_metrics), ref_grads = ref[chunk]
    loss = loss.detach()
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    ce = float(metrics["ce"].detach())
    assert abs(ce - float(ref_metrics["ce"])) <= TOL * abs(float(ref_metrics["ce"]))
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    _assert_trees(named_to_reference(model, grads), jax.tree.map(np.asarray, ref_grads),
                  "grads")


def test_train_step_matches_the_reference(arch):
    """One ``make_train_step`` step (remat on) from the reference's state
    at ``init_opt_state``: every weight, moment, the count and the
    metrics."""
    cfg, tree, batch, ref = arch
    state = train_state_from_reference(
        cfg, {"params": tree, "opt": jax.tree.map(np.asarray, ref_init_opt_state(tree))}, "cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    state, metrics = make_train_step(cfg, OptimizerConfig(**OPT))(state, batch)
    ref_state, ref_metrics = ref["step"]
    assert set(metrics) == set(ref_metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for k in metrics:
        assert abs(float(metrics[k]) - float(ref_metrics[k])) <= \
            TOL * max(abs(float(ref_metrics[k])), 1e-30), k
    _assert_trees(train_state_to_reference(state), jax.tree.map(np.asarray, ref_state), "state")
    assert int(state["opt"]["count"]) == 1
