"""The port's model layers (``repro_torch.models``) against the JAX
package's, layer by layer, in f32 on the CPU.

Weights come from the reference's ``init_params`` and are carried into the
port by ``params_from_reference``; activations are drawn with numpy from a
seed and handed to both. Each layer is held at ``max |port - ref| <= TOL *
max |ref|`` with TOL = 1e-5 (the two frameworks' f32 kernels sum in other
orders), except where a bound is stated beside the test. On the CPU the
port's attention runs its plain path (``attention_reference``), as the
reference does off a TPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.attention as ref_attn
import repro.models.common as ref_common
import repro.models.ffn as ref_ffn
import repro.models.ssm as ref_ssm
import repro.models.tuning as ref_tuning
import repro_torch.configs as port_configs
import repro_torch.models.attention as attn
import repro_torch.models.common as common
import repro_torch.models.ffn as ffn
import repro_torch.models.ssm as ssm
import repro_torch.models.tuning as tuning
from repro.models import init_params as ref_init_params
from repro_torch.convert import params_from_reference

TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_err(port, ref) -> float:
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, scale, s)).astype(np.float32) for s in shapes]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


_MODELS = {}


def _model(arch, **scaled):
    """(reference cfg, reference params, port cfg, port LM) for ``arch``'s
    smoke config, weights from the reference's init (cached per module)."""
    key = (arch, tuple(sorted(scaled.items())))
    if key not in _MODELS:
        rcfg = ref_configs.get_smoke(arch).scaled(**scaled)
        pcfg = port_configs.get_smoke(arch).scaled(**scaled)
        tree = jax.tree.map(np.asarray, jax.jit(ref_init_params, static_argnums=0)(
            rcfg, jax.random.PRNGKey(7)))
        _MODELS[key] = rcfg, tree, pcfg, params_from_reference(pcfg, tree, "cpu")
    return _MODELS[key]


def _layer(tree, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree)


def _jit(fn, cfg):
    """The reference's ``fn(cfg, ...)`` jitted for ``cfg`` (one compile for
    the decode loops, where eager JAX dispatches op by op)."""
    return jax.jit(lambda *a, **kw: fn(cfg, *a, **kw))


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    ref_tuning.reset_tuning()
    tuning.reset_tuning()


def _set_knobs(**kw):
    ref_tuning.set_tuning(**kw)
    tuning.set_tuning(**kw)
    assert tuning.tuning_tag() == ref_tuning.tuning_tag()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16_io", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(bf16_io, dtype):
    """f32 at 1e-5; bf16 at 2**-7 of max |ref| (one bf16 rounding of the
    output, where the two frameworks' f32 inner sums differ in the last
    bit)."""
    x, g = _draw(0, (2, 8, 64), (64,))
    _set_knobs(norm_bf16_io=bf16_io)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = ref_common.rms_norm(jnp.asarray(x, jd), jnp.asarray(g * 0.1, jd))
    port = common.rms_norm(_t(x, td), _t(np.asarray(jnp.asarray(g * 0.1, jd), np.float32), td))
    assert port.dtype == td
    assert rel_err(port, ref) <= (TOL if dtype == "float32" else 2 ** -7)


def test_rotary_and_apply_rope():
    x, = _draw(1, (2, 16, 4, 32))
    pos = np.arange(3, 19)[None, :].repeat(2, 0)
    rc, rs = ref_common.rotary_embedding(jnp.asarray(pos), 32, 10000.0)
    pc, ps = common.rotary_embedding(torch.from_numpy(pos), 32, 10000.0)
    assert rel_err(pc, rc) <= TOL and rel_err(ps, rs) <= TOL
    assert rel_err(common.apply_rope(_t(x), pc, ps),
                   ref_common.apply_rope(jnp.asarray(x), rc, rs)) <= TOL
    # bf16 x times the f32 tables is computed in f32 and rounded once, in
    # both packages: equal to the bit
    xb = jnp.asarray(x, jnp.bfloat16)
    port = common.apply_rope(_t(np.asarray(xb, np.float32), torch.bfloat16), pc, ps)
    assert port.dtype == torch.bfloat16
    assert rel_err(port, ref_common.apply_rope(xb, rc, rs)) <= 2 ** -8


def test_softcap_and_activations():
    x, = _draw(2, (4, 64), scale=40.0)
    assert rel_err(common.softcap(_t(x), 30.0), ref_common.softcap(jnp.asarray(x), 30.0)) <= TOL
    assert torch.equal(common.softcap(_t(x), 0.0), _t(x))
    for name in ("swiglu", "geglu"):
        assert rel_err(common.activation_fn(name)(_t(x / 10)),
                       ref_common.activation_fn(name)(jnp.asarray(x / 10))) <= TOL
    with pytest.raises(ValueError):
        common.activation_fn("relu6")


def test_cross_entropy_loss():
    logits, = _draw(3, (2, 8, 50), scale=3.0)
    labels = np.random.default_rng(3).integers(0, 50, (2, 8))
    mask = np.random.default_rng(4).integers(0, 2, (2, 8))
    for m in (None, mask):
        ref = ref_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                            None if m is None else jnp.asarray(m))
        port = common.cross_entropy_loss(_t(logits), torch.from_numpy(labels),
                                         None if m is None else torch.from_numpy(m))
        assert rel_err(port, ref) <= TOL


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    ("causal", (1, 64, 64, 4, 2, 16), dict()),
    ("window 8", (2, 64, 64, 4, 2, 16), dict(window=8)),
    ("softcap", (1, 64, 64, 4, 1, 32), dict(logit_cap=5.0)),
    ("decode q_offset kv_len window", (2, 1, 40, 4, 2, 16),
     dict(causal=False, q_offset=30, kv_len=31, window=8)),
    ("prefill at q_offset", (1, 20, 48, 4, 2, 16), dict(q_offset=20, kv_len=40)),
    ("non-causal cross", (2, 16, 24, 4, 4, 16), dict(causal=False)),
    ("Q_CHUNK blocking S=2048", (1, 2048, 2048, 2, 1, 16), dict(window=300)),
]


@pytest.mark.parametrize("knob", ["baseline", "attn_additive_mask", "attn_probs_bf16"])
@pytest.mark.parametrize("label,shape,kw", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_reference(knob, label, shape, kw):
    """The plain attention path and its two knobs. ``attn_probs_bf16``
    rounds the probabilities to bf16 in both packages: 2**-7 of max |ref|
    (one bf16 rounding the two frameworks may take on either side)."""
    b, s, t, h, hkv, d = shape
    q, k, v = _draw(4, (b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))
    if knob != "baseline":
        _set_knobs(**{knob: True})
    ref = ref_attn.attention_reference(*map(jnp.asarray, (q, k, v)), **kw)
    port = attn.attention_reference(_t(q), _t(k), _t(v), **kw)
    assert rel_err(port, ref) <= (2 ** -7 if knob == "attn_probs_bf16" else TOL)
    # impl="auto" on CPU tensors is the same plain path
    if knob == "baseline":
        assert torch.equal(attn.attention_op(_t(q), _t(k), _t(v), **kw), port)


def test_attention_op_routes():
    q, k, v = (_t(a) for a in _draw(5, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    assert torch.equal(attn.attention_op(q, k, v, impl="ref"),
                       attn.attention_reference(q, k, v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn.attention_op(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.attention_op(q, k, v, impl="sdpa")


@pytest.mark.parametrize("is_global", [True, False])
def test_attn_block_and_decode_gemma2_alternation(is_global):
    """gemma2's local (window 8) and global layers with soft-cap 50: the
    block over 24 tokens, then decode steps at positions 20-23 against a
    cache filled by the block's own keys (decode == block within 1e-5)."""
    rcfg, tree, pcfg, model = _model("gemma2-2b")
    layer = 0 if not is_global else 1
    assert pcfg.is_global_layer(layer) == is_global
    rp = _layer(tree["segments"][0]["attn"], layer)
    pp = model.segments[0][layer].attn
    x, = _draw(6, (2, 24, pcfg.d_model), scale=0.5)
    ref = _jit(ref_attn.attn_block, rcfg)(rp, jnp.asarray(x), is_global=jnp.asarray(is_global))
    port = attn.attn_block(pcfg, pp, _t(x), is_global=is_global)
    assert rel_err(port, ref) <= TOL
    assert torch.equal(pp(_t(x), is_global=is_global), port)

    t = 32
    rk = jnp.zeros((2, t, pcfg.n_kv_heads, pcfg.hd))
    rv = jnp.zeros_like(rk)
    pk, pv = torch.zeros(2, t, pcfg.n_kv_heads, pcfg.hd), torch.zeros(2, t, pcfg.n_kv_heads, pcfg.hd)
    ref_step = _jit(ref_attn.attn_decode_step, rcfg)
    for pos in range(24):
        xi = x[:, pos:pos + 1]
        ro, rk, rv = ref_step(rp, jnp.asarray(xi), rk, rv, jnp.int32(pos),
                              is_global=jnp.asarray(is_global))
        po, pk2, pv2 = attn.attn_decode_step(pcfg, pp, _t(xi), pk, pv, pos, is_global=is_global)
        assert pk2 is pk and pv2 is pv      # updated in place
        assert rel_err(po, ro) <= TOL
        assert rel_err(po[:, 0], port[:, pos]) <= TOL     # decode == block
    assert rel_err(pk, rk) <= TOL and rel_err(pv, rv) <= TOL


def test_cross_attention_block():
    rcfg, tree, pcfg, model = _model("seamless-m4t-medium")
    rp = _layer(tree["segments"][0]["cross"], 0)
    x, mem = _draw(7, (2, 6, pcfg.d_model), (2, 16, pcfg.d_model), scale=0.5)
    ref = _jit(ref_attn.attn_block, rcfg)(rp, jnp.asarray(x), kv=jnp.asarray(mem))
    port = attn.attn_block(pcfg, model.segments[0][0].cross, _t(x), kv=_t(mem))
    assert rel_err(port, ref) <= TOL


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_block_and_decode(q_lora):
    """DeepSeek-V2 MLA, with and without the low-rank query path: the block
    over 12 tokens, and the latent-cache decode step by step (decode ==
    block within 1e-5)."""
    scaled = {} if q_lora else dict(q_lora_rank=0)
    rcfg, tree, pcfg, model = _model("deepseek-v2-236b", **scaled)
    rp = _layer(tree["segments"][0]["attn"], 0)
    pp = model.segments[0][0].attn
    assert hasattr(pp, "w_dq") == q_lora
    x, = _draw(8, (2, 12, pcfg.d_model), scale=0.5)
    ref = _jit(ref_attn.mla_block, rcfg)(rp, jnp.asarray(x))
    port = attn.mla_block(pcfg, pp, _t(x))
    assert rel_err(port, ref) <= TOL
    t = 16
    rc = jnp.zeros((2, t, pcfg.kv_lora_rank))
    rr = jnp.zeros((2, t, pcfg.rope_head_dim))
    pc, pr = torch.zeros(2, t, pcfg.kv_lora_rank), torch.zeros(2, t, pcfg.rope_head_dim)
    ref_step = _jit(ref_attn.mla_decode_step, rcfg)
    for pos in range(12):
        xi = x[:, pos:pos + 1]
        ro, rc, rr = ref_step(rp, jnp.asarray(xi), rc, rr, jnp.int32(pos))
        po, _, _ = attn.mla_decode_step(pcfg, pp, _t(xi), pc, pr, pos)
        assert rel_err(po, ro) <= TOL
        assert rel_err(po[:, 0], port[:, pos]) <= TOL
    assert rel_err(pc, rc) <= TOL and rel_err(pr, rr) <= TOL


# ---------------------------------------------------------------------------
# FFN and MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "granite-20b", "pixtral-12b"])
def test_ffn_block(arch):
    """GeGLU (gemma), plain GELU MLP (granite), SwiGLU (pixtral)."""
    rcfg, tree, pcfg, model = _model(arch)
    x, = _draw(9, (2, 10, pcfg.d_model), scale=0.5)
    ref = _jit(ref_ffn.ffn_block, rcfg)(_layer(tree["segments"][0]["ffn"], 0), jnp.asarray(x))
    assert rel_err(ffn.ffn_block(pcfg, model.segments[0][0].ffn, _t(x)), ref) <= TOL


def _n_dropped(topi: np.ndarray, e: int, capacity: int, grouped: bool) -> int:
    """Choices past their expert's capacity, counted the reference's way:
    positions in the flattened (token, k) order of each dispatch group."""
    groups = topi.reshape(topi.shape[0], -1) if grouped else topi.reshape(1, -1)
    dropped = 0
    for g in groups:
        seen = np.zeros(e, int)
        for ex in g:
            dropped += seen[ex] >= capacity
            seen[ex] += 1
    return int(dropped)


@pytest.mark.parametrize("seq", [32, 128], ids=["global S=32", "grouped S=128"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_block_drops_tokens(arch, seq):
    """Both dispatch regimes at capacity_factor 0.5, small enough that
    tokens are dropped (asserted, so the test cannot pass vacuously): the
    output and the Switch auxiliary loss. deepseek adds shared experts."""
    rcfg, tree, pcfg, model = _model(arch)
    # capacity_factor is read by the dispatch only: the same weights
    rcfg, pcfg = rcfg.scaled(capacity_factor=0.5), pcfg.scaled(capacity_factor=0.5)
    seg = len(tree["segments"]) - 1
    rp = _layer(tree["segments"][seg]["moe"], 0)
    pp = model.segments[seg][0].moe
    x, = _draw(10, (2, seq, pcfg.d_model))
    ref_out, ref_aux = _jit(ref_ffn.moe_block, rcfg)(rp, jnp.asarray(x))
    out, aux = ffn.moe_block(pcfg, pp, _t(x))
    assert rel_err(out, ref_out) <= TOL
    assert abs(float(aux) - float(ref_aux)) <= TOL * abs(float(ref_aux))
    probs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    _, topi = jax.lax.top_k(probs, pcfg.moe_top_k)
    e, k, b = pcfg.n_experts, pcfg.moe_top_k, 2
    n_tok = seq if seq > 64 else b * seq
    capacity = max(int(np.ceil(0.5 * k * n_tok / e)), 4)
    assert _n_dropped(np.asarray(topi), e, capacity, grouped=seq > 64) > 0
    assert pp.cfg.capacity_factor == 1.25   # the module's own config
    assert torch.equal(ffn.moe_block(pcfg, pp, _t(x))[0], out)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def test_ssd_chunked():
    x, B, C = _draw(11, (2, 32, 4, 8), (2, 32, 16), (2, 32, 16), scale=0.5)
    dta = -np.abs(_draw(12, (2, 32, 4), scale=0.3)[0]) - 0.01
    ry, rs = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dta, B, C)), 8)
    py, ps = ssm.ssd_chunked(_t(x), _t(dta), _t(B), _t(C), 8)
    assert rel_err(py, ry) <= TOL and rel_err(ps, rs) <= TOL


def test_ssm_block_and_decode():
    """mamba2's block over 24 tokens and its O(1) decode step by step, each
    against the reference at 1e-5 (the cache too), and the reference's own
    "decode equals train" check on the port at its 5e-4
    (``tests/test_kernels.py::test_ssm_block_decode_matches_train``)."""
    rcfg, tree, pcfg, model = _model("mamba2-1.3b")
    rp = _layer(tree["segments"][0]["ssm"], 1)
    pp = model.segments[0][1].ssm
    x, = _draw(13, (2, 24, pcfg.d_model), scale=0.3)
    ref = _jit(ref_ssm.ssm_block, rcfg)(rp, jnp.asarray(x))
    port = ssm.ssm_block(pcfg, pp, _t(x))
    assert rel_err(port, ref) <= TOL
    rc = ref_ssm.init_ssm_cache(rcfg, 2, jnp.float32)
    pc = ssm.init_ssm_cache(pcfg, 2, torch.float32, device="cpu")
    outs = []
    ref_step = _jit(ref_ssm.ssm_decode_step, rcfg)
    for i in range(24):
        ro, rc = ref_step(rp, jnp.asarray(x[:, i:i + 1]), rc)
        po, pc2 = ssm.ssm_decode_step(pcfg, pp, _t(x[:, i:i + 1]), pc)
        assert pc2 is pc
        assert rel_err(po, ro) <= TOL
        outs.append(po[:, 0])
    for name in rc:
        assert rel_err(pc[name], rc[name]) <= TOL, name
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(port), rtol=5e-4, atol=5e-4)
