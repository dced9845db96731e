"""The port's serving path around the model: carrying weights across
(``params_from_reference`` / ``params_to_reference``), the step functions
against the reference's, the port's own initialisation, the serve example
on the CPU, and what the port refuses (no card) or pads (a head dim the
flash kernels lack)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro_torch.configs as port_configs
from repro.launch.steps import make_decode_step as ref_make_decode_step
from repro.launch.steps import make_prefill_step as ref_make_prefill_step
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.kernels.flash_attention.kernel import (check_kernel_layout, pad_head_dim,
                                                        padded_head_dim)
from repro_torch.launch import make_decode_step, make_prefill_step
from repro_torch.models import init_cache, init_params, num_params
from repro_torch.models.lm import encode

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ref_configs.ARCHS


def _reference_shaped_tree(cfg, seed):
    """A pytree of the reference's ``init_params`` structure, shapes and
    types (``jax.eval_shape``: nothing is computed), filled with numpy
    draws: the conversion is checked on every leaf without paying the
    reference's initialisation."""
    rng = np.random.default_rng(seed)
    abstract = jax.eval_shape(lambda k: ref_models.init_params(cfg, k), jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: np.asarray(jnp.asarray(rng.normal(0.0, 1.0, s.shape), s.dtype)), abstract)


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


CASES = [(a, "float32") for a in ARCHS] + [("gemma2-2b", "bfloat16"), ("deepseek-v2-236b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CASES, ids=[f"{a}-{d}" for a, d in CASES])
def test_params_round_trip_is_exact(arch, dtype):
    """Reference tree -> port LM -> reference tree, bit for bit, for every
    architecture (the stacked layer axis of ``segments``, a hybrid's
    ``inner``, the encoder's ``segment``; ``shared_attn``/``shared_ffn``,
    ``unembed``) and in bf16."""
    rcfg = ref_configs.get_smoke(arch).scaled(dtype=dtype)
    pcfg = port_configs.get_smoke(arch).scaled(dtype=dtype)
    tree = _reference_shaped_tree(rcfg, seed=len(arch))
    model = params_from_reference(pcfg, tree, "cpu")
    assert num_params(model) == sum(a.size for a in jax.tree.leaves(tree))
    _assert_same_tree(tree, params_to_reference(model))


def test_params_from_reference_refuses_a_tree_that_does_not_fit():
    cfg = port_configs.get_smoke("gemma2-2b")
    tree = _reference_shaped_tree(ref_configs.get_smoke("gemma2-2b"), seed=0)
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(cfg, bad, "cpu")
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="sets no"):
        params_from_reference(cfg, short, "cpu")
    with pytest.raises(ValueError, match="stacks"):
        params_from_reference(cfg.scaled(n_layers=2), tree, "cpu")


@pytest.mark.parametrize("arch", ["gemma2-2b", "seamless-m4t-medium"])
def test_steps_match_the_reference(arch):
    """``make_prefill_step`` (full-sequence logits) and ``make_decode_step``
    (3 steps, with encoder memory for seamless) against the reference's
    steps on the same weights, at 1e-4 of max |logit|."""
    rcfg, pcfg = ref_configs.get_smoke(arch), port_configs.get_smoke(arch)
    params = jax.jit(ref_models.init_params, static_argnums=0)(rcfg, jax.random.PRNGKey(5))
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, pcfg.vocab_size, (2, 12)).astype(np.int32)
    rbatch, pbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if pcfg.frontend == "audio":
        front = rng.normal(0.0, 1.0, (2, pcfg.frontend_tokens, pcfg.d_model)).astype(np.float32)
        rbatch["memory"] = ref_models.encode(rcfg, params, jnp.asarray(front))
        pbatch["memory"] = encode(pcfg, model, torch.from_numpy(front))

    def err(p, r):
        r = np.asarray(r, np.float32)
        return float(np.abs(p.float().numpy() - r).max() / np.abs(r).max())

    ref_logits = jax.jit(ref_make_prefill_step(rcfg, remat=False))(params, rbatch)
    assert err(make_prefill_step(pcfg)(model, pbatch), ref_logits) <= 1e-4
    rstep, pstep = jax.jit(ref_make_decode_step(rcfg)), make_decode_step(pcfg)
    rcache, pcache = ref_models.init_cache(rcfg, 2, 8), init_cache(pcfg, 2, 8, device="cpu")
    for i in range(3):
        rl, rcache = rstep(params, rcache, dict(rbatch, tokens=jnp.asarray(toks[:, i:i + 1])))
        pl, pcache = pstep(model, pcache, dict(pbatch, tokens=pbatch["tokens"][:, i:i + 1]))
        assert err(pl, rl) <= 1e-4, i
    assert pcache["pos"] == 3


STD = 0.8796   # std of a standard normal truncated to [-2, 2]


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x22b", "deepseek-v2-236b",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_init_params_statistics(arch):
    """The port's own initialisation (Philox, so statistical, not the
    reference's bits): every dense matrix has std within 3% of
    0.8796/sqrt(fan_in) and mean within 4 standard errors of 0; embeddings
    0.8796; norm gains zero; SSM convs 0.1, ``a_log`` log(1..nh),
    ``d_skip`` one, ``dt_bias`` zero. Widths are raised from the smoke
    config so each matrix has >= 8192 entries (a 3% band is then > 3.5
    standard errors of the std). Seeded: the same seed draws the same
    weights, another seed others."""
    smoke = port_configs.get_smoke(arch)
    cfg = smoke.scaled(d_model=256, d_ff=512, moe_d_ff=256, vocab_size=1024,
                       head_dim=32, n_experts=32 if smoke.n_experts else 0,
                       kv_lora_rank=64, q_lora_rank=64, rope_head_dim=32,
                       ssm_head_dim=16, ssm_state=32)
    model = init_params(cfg, device="cpu", seed=11)
    n_checked = 0
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        x = p.double()
        if leaf.startswith("norm") or leaf.endswith("_norm") or leaf in ("dt_bias",):
            assert torch.count_nonzero(x) == 0, name
            continue
        if leaf == "d_skip":
            assert torch.all(x == 1), name
            continue
        if leaf == "a_log":
            assert torch.allclose(x, torch.log(torch.arange(1, x.numel() + 1).double()))
            continue
        if leaf.startswith("conv_"):
            want = 0.1
        elif leaf in ("embed", "unembed"):
            want = STD
        else:
            want = STD / np.sqrt(p.shape[-2])      # fan_in: (in, out) or (E, in, out)
        assert p.numel() >= 8192 or leaf.startswith("conv_"), (name, p.shape)
        std = float(x.std())
        assert abs(std / want - 1) <= (0.03 if not leaf.startswith("conv_") else 0.15), \
            (name, std, want)
        assert abs(float(x.mean())) <= 4 * want / np.sqrt(p.numel()), name
        n_checked += 1
    assert n_checked >= 8
    again = init_params(cfg, device="cpu", seed=11)
    other = init_params(cfg, device="cpu", seed=12)
    assert torch.equal(again.embed, model.embed)
    assert not torch.equal(other.embed, model.embed)


def test_serve_example_runs_on_the_cpu():
    """``examples/serve_lm_torch.py --device cpu`` on the gemma2 smoke
    config, in a subprocess: it prints what the reference example prints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
                           "--arch", "gemma2-2b", "--device", "cpu", "--tokens", "8",
                           "--prompt-len", "8", "--batch", "2"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 tokens in ")
    assert lines[1] == "decode: 8 steps x 2 seqs"
    assert lines[2].startswith("per-step latency (Tukey-filtered): ")
    assert "95% CI" in lines[2] and lines[3].startswith("sample token ids:")


def test_init_params_wants_the_card():
    """Without a device argument the entry point asks for CUDA, and without
    a card it raises; it never quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: init_params(cfg) rightly runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(port_configs.get_smoke("gemma2-2b"))


@pytest.mark.parametrize("arch,d", [("zamba2-7b", 112), ("deepseek-v2-236b", 192), (None, 320)],
                         ids=["zamba2-7b", "deepseek-v2-236b", "d320"])
def test_head_dims_the_kernel_lacks_raise(arch, d):
    """At full width zamba2 has head dim 112 and deepseek-v2's MLA 128 + 64
    = 192. The flash kernels are built for 16-256 in powers of two, so they
    lack both: the layout check refuses them as they are. The wrapper runs
    them zero-padded to the next built dim (128, 256), where the check
    passes; a head dim above 256 (320) has no such dim and raises."""
    if arch is not None:
        cfg = port_configs.get_config(arch)
        assert cfg.hd + (cfg.rope_head_dim if cfg.kv_lora_rank else 0) == d
    q = torch.zeros(1, 4, 2, d)
    with pytest.raises(ValueError, match="head dims"):
        check_kernel_layout(q, q, q)
    if d > 256:
        with pytest.raises(ValueError, match="head dims"):
            padded_head_dim(d)
        return
    assert check_kernel_layout(*pad_head_dim(q, q, q)) == "tf32x3"
    assert padded_head_dim(d) == {112: 128, 192: 256}[d]
