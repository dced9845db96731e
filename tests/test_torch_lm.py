"""The port's language model (``repro_torch.models.lm``) against the JAX
package's, per architecture, for all ten ``SMOKE`` configs, in f32 on the
CPU.

Weights come from the reference's ``init_params`` and are carried by
``params_from_reference``; token ids, patch embeddings (pixtral) and
speech-frame embeddings (seamless, through each package's ``encode``) are
drawn with numpy from a seed. Held against the reference at ``max |port -
ref| <= 1e-4 * max |ref|``: ``forward`` logits and auxiliary loss, three
``decode_step``\\ s from ``init_cache`` and the cache they leave, ``prefill``
of 8 tokens and its cache, ``loss_fn`` with and without ``ce_chunk``. The
port's prefill equals its repeated decode at the reference's 2e-4
(``tests/test_models.py::test_prefill_decode_consistency``). One bf16
case (gemma2) is held at the bound stated on its test.

The reference runs jitted (with ``remat=False``, which changes no value),
once per architecture in a module-scoped fixture.
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
import repro_torch.models as models
import repro_torch.models.tuning as tuning
from repro.models.lm import encode as ref_encode
from repro_torch.convert import params_from_reference
from repro_torch.models.lm import encode

ARCHS = ref_configs.ARCHS
#: Depth cuts, in both packages, that keep the file inside its time budget
#: (the reference's jit compiles dominate it) and every segment kind of the
#: architecture: zamba2 one hybrid super-block (2 SSM layers + the shared
#: attention) and the SSM tail, deepseek its dense first layer and one MoE
#: layer.
DEPTH = {"zamba2-7b": 3, "deepseek-v2-236b": 2}
TOL = 1e-4
B, S, PROMPT, MAX_LEN = 2, 16, 8, 12


def rel_err(port, ref) -> float:
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    front = None
    if cfg.frontend:
        front = rng.normal(0.0, 1.0, (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, front


def _reference(cfg, toks, front):
    """Everything the tests compare, from the reference, jitted."""
    def f(fn, **static):
        return jax.jit(lambda *a, **kw: fn(cfg, *a, **static, **kw))

    params = jax.jit(ref_models.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(3))
    out = {"params": jax.tree.map(np.asarray, params)}
    kw = {}
    if cfg.frontend == "vision":
        kw["embeds"] = jnp.asarray(front)
    if cfg.frontend == "audio":
        kw["memory"] = out["memory"] = f(ref_encode, remat=False)(params, jnp.asarray(front))
    mem = kw.get("memory")
    out["logits"], out["aux"] = f(ref_models.forward, remat=False)(params, jnp.asarray(toks), **kw)
    cache = ref_models.init_cache(cfg, B, MAX_LEN)
    step = f(ref_models.decode_step)
    out["decode"] = []
    for i in range(3):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]), memory=mem)
        out["decode"].append(lg)
    out["decode_cache"] = cache
    out["prefill"], out["prefill_cache"] = f(ref_models.prefill, max_len=MAX_LEN)(
        params, jnp.asarray(toks[:, :PROMPT]), memory=mem)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.roll(jnp.asarray(toks), -1, axis=1), **kw}
    out["loss"] = f(ref_models.loss_fn, remat=False)(params, batch)
    ref_tuning.set_tuning(ce_chunk=4)
    try:     # the knob is read while tracing: a fresh jit
        out["loss_chunked"] = f(ref_models.loss_fn, remat=False)(params, batch)
    finally:
        ref_tuning.reset_tuning()
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    depth = {"n_layers": DEPTH[request.param]} if request.param in DEPTH else {}
    rcfg = ref_configs.get_smoke(request.param).scaled(**depth)
    pcfg = port_configs.get_smoke(request.param).scaled(**depth)
    toks, front = _inputs(pcfg)
    ref = _reference(rcfg, toks, front)
    model = params_from_reference(pcfg, ref["params"], "cpu")
    kw = {}
    if pcfg.frontend == "vision":
        kw["embeds"] = torch.from_numpy(front)
    if pcfg.frontend == "audio":
        kw["memory"] = encode(pcfg, model, torch.from_numpy(front))
    return pcfg, model, torch.from_numpy(toks).long(), kw, ref


def _assert_cache(port, ref):
    assert port["pos"] == int(ref["pos"])
    for p_seg, r_seg in zip(port["segments"], ref["segments"], strict=True):
        flat_p = jax.tree_util.tree_leaves_with_path(p_seg)
        flat_r = jax.tree_util.tree_leaves_with_path(r_seg)
        assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
        for (path, p), (_, r) in zip(flat_p, flat_r):
            assert rel_err(p, r) <= TOL, path


def test_forward(arch):
    cfg, model, toks, kw, ref = arch
    if "memory" in kw:
        assert rel_err(kw["memory"], ref["memory"]) <= TOL
    logits, aux = models.forward(cfg, model, toks, **kw)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert rel_err(logits, ref["logits"]) <= TOL
    assert abs(float(aux) - float(ref["aux"])) <= TOL * max(abs(float(ref["aux"])), 1.0)
    if cfg.n_experts:
        assert float(aux) > 0
    assert torch.equal(model(toks, **kw)[0], logits)


def test_decode_steps(arch):
    cfg, model, toks, kw, ref = arch
    cache = models.init_cache(cfg, B, MAX_LEN, device="cpu")
    for i in range(3):
        lg, cache2 = models.decode_step(cfg, model, cache, toks[:, i:i + 1],
                                        memory=kw.get("memory"))
        assert cache2 is cache
        assert rel_err(lg, ref["decode"][i]) <= TOL, i
    _assert_cache(cache, ref["decode_cache"])


def test_prefill_and_cache(arch):
    """``prefill`` of 8 tokens and its cache against the reference, and
    against the port's own repeated decode (2e-4)."""
    cfg, model, toks, kw, ref = arch
    mem = kw.get("memory")
    logits, cache = models.prefill(cfg, model, toks[:, :PROMPT], memory=mem, max_len=MAX_LEN)
    assert logits.shape == (B, PROMPT, cfg.vocab_size)
    assert rel_err(logits, ref["prefill"]) <= TOL
    _assert_cache(cache, ref["prefill_cache"])
    c = models.init_cache(cfg, B, MAX_LEN, device="cpu")
    steps = [models.decode_step(cfg, model, c, toks[:, i:i + 1], memory=mem)[0][:, 0]
             for i in range(PROMPT)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), logits.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_loss_fn(arch):
    cfg, model, toks, kw, ref = arch
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1), **kw}
    for key, chunk in (("loss", 0), ("loss_chunked", 4)):
        tuning.set_tuning(ce_chunk=chunk)
        try:
            loss, metrics = models.loss_fn(cfg, model, batch)
        finally:
            tuning.reset_tuning()
        ref_loss, ref_metrics = ref[key]
        assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss)), key
        assert abs(float(metrics["ce"]) - float(ref_metrics["ce"])) <= TOL * abs(float(ref_metrics["ce"]))
    assert tuning.tuning_tag() == "baseline"


def test_gemma2_bf16_forward_and_decode():
    """gemma2's smoke config in bf16, weights from the reference's bf16
    init: ``forward`` and 3 decode steps within 1e-2 of max |logit| (bf16
    keeps 8 bits; the two frameworks round matmul outputs at other places
    and four layers compound it: 6.4e-3 measured on ``forward``, where f32
    gives 2.6e-7)."""
    rcfg = ref_configs.get_smoke("gemma2-2b").scaled(dtype="bfloat16")
    pcfg = port_configs.get_smoke("gemma2-2b").scaled(dtype="bfloat16")
    toks, _ = _inputs(pcfg, seed=1)
    params = jax.jit(ref_models.init_params, static_argnums=0)(rcfg, jax.random.PRNGKey(4))
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, params), "cpu")
    assert model.embed.dtype == torch.bfloat16
    ref_logits, _ = jax.jit(lambda p, t: ref_models.forward(rcfg, p, t, remat=False))(
        params, jnp.asarray(toks))
    logits, _ = models.forward(pcfg, model, torch.from_numpy(toks).long())
    assert logits.dtype == torch.bfloat16
    assert rel_err(logits, ref_logits) <= 1e-2
    cache = models.init_cache(pcfg, B, MAX_LEN, device="cpu")
    rcache = ref_models.init_cache(rcfg, B, MAX_LEN)
    step = jax.jit(lambda p, c, t: ref_models.decode_step(rcfg, p, c, t))
    for i in range(3):
        rl, rcache = step(params, rcache, jnp.asarray(toks[:, i:i + 1]))
        lg, cache = models.decode_step(pcfg, model, cache, torch.from_numpy(toks[:, i:i + 1]).long())
        assert rel_err(lg, rl) <= 1e-2, i
