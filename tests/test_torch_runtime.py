"""The port's runtime substrate against the JAX package's: the data
pipeline, the prefetcher, the checkpoint store, the supervised trainer and
the straggler monitor (the reference's ``tests/test_runtime.py`` tests
ported), batches bit for bit, and checkpoints across the two packages in
both directions, bf16 leaves included. The reference's
``test_elastic_restore_to_different_mesh`` restores onto a JAX device mesh;
its port waits for the sharding slice (DTensor placements). The training
examples run on the CPU in a subprocess."""

import json
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
from repro.checkpoint.store import CheckpointConfig as RefCheckpointConfig
from repro.checkpoint.store import CheckpointStore as RefCheckpointStore
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.optim import OptimizerConfig as RefOptimizerConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import init_opt_state as ref_init_opt_state
from repro_torch.checkpoint import CheckpointConfig, CheckpointStore
from repro_torch.convert import (load_train_state, train_state_from_reference,
                                 train_state_to_reference, train_state_tree)
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import init_train_state, make_train_step
from repro_torch.models import LM, ModelConfig, init_params
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime import (FailureInjector, StragglerMonitor, Trainer, TrainerConfig,
                                 run_supervised)
from repro_torch.runtime.trainer import to_device

ROOT = Path(__file__).resolve().parents[1]
TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                   dtype="float32")


def test_data_pipeline_deterministic_and_sharded():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=8)
    src = SyntheticLM(cfg)
    a = src.batch_at(5)
    b = src.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = src.batch_at(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # host sharding partitions the global batch
    h0 = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=8,
                                host_index=0, host_count=2))
    h1 = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=8,
                                host_index=1, host_count=2))
    assert h0.batch_at(0)["tokens"].shape == (4, 16)
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])


@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_batches_equal_the_reference(host):
    """``batch_at(step)`` is the reference's, bit for bit and type for type."""
    kw = dict(vocab_size=256000, seq_len=64, global_batch=4, seed=7,
              host_index=host[0], host_count=host[1])
    port, ref = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(RefDataConfig(**kw))
    for step in (0, 1, 12345):
        a, b = port.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_orders_batches():
    src = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=2))
    pf = Prefetcher(src, start_step=3)
    try:
        for expect in (3, 4, 5):
            step, batch = pf.next()
            assert step == expect
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(expect)["tokens"])
    finally:
        pf.close()


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(CheckpointConfig(directory=str(tmp_path),
                                             async_save=False))
    state = {"a": torch.arange(6).reshape(2, 3).float(),
             "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    store.save(7, state)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
    restored, step = store.restore(like)
    assert step == 7
    assert torch.equal(restored["a"], state["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], state["b"]["c"])


def test_checkpoint_retention(tmp_path):
    store = CheckpointStore(CheckpointConfig(directory=str(tmp_path),
                                             keep=2, async_save=False))
    for s in (1, 2, 3, 4):
        store.save(s, {"x": torch.zeros(3)})
    assert store.all_steps() == [3, 4]


def test_checkpoint_restore_refuses_another_tree(tmp_path):
    store = CheckpointStore(CheckpointConfig(directory=str(tmp_path), async_save=False))
    store.save(1, {"x": torch.zeros(3), "y": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        store.restore({"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaf 0"):
        store.restore({"x": torch.zeros(4), "y": torch.zeros(2)})


def test_async_save_snapshots_at_the_call(tmp_path):
    """The leaves are copied when ``save`` is called: changing the tensor
    afterwards (the next train step) does not reach the file."""
    store = CheckpointStore(CheckpointConfig(directory=str(tmp_path)))
    x = torch.zeros(1 << 16)
    store.save(1, {"x": x})
    x.fill_(1.0)
    restored, _ = store.restore({"x": torch.empty(1 << 16)})
    assert not restored["x"].any()


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_failure_restart_resumes_and_matches(tmp_path, async_save):
    """The supervisor restarts from the checkpoint after an injected
    failure and reaches the same final loss as an uninterrupted run
    (deterministic data + checkpointed state), with synchronous and with
    background saves."""
    data = DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=9)
    tc = TrainerConfig(total_steps=12, save_every=4, log_every=100)

    clean = Trainer(TINY, data, trainer_cfg=tc, device="cpu",
                    ckpt_cfg=CheckpointConfig(directory=str(tmp_path / "clean"),
                                              async_save=async_save))
    out_clean = run_supervised(clean)

    faulty = Trainer(TINY, data, trainer_cfg=tc, device="cpu",
                     ckpt_cfg=CheckpointConfig(directory=str(tmp_path / "faulty"),
                                               async_save=async_save))
    out_faulty = run_supervised(faulty, FailureInjector(fail_at=(6,)))
    assert out_faulty["restarts"] == 1
    assert abs(out_clean["losses"][-1] - out_faulty["losses"][-1]) < 1e-4
    # steps 0-5, then 4-11 again from the step-4 checkpoint
    assert faulty.store.all_steps() == [4, 8, 12] and len(out_faulty["losses"]) == 6 + 8


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(window=30)
    rng = np.random.default_rng(0)
    flagged = False
    for i in range(40):
        dt = 0.1 + rng.normal(0, 0.002)
        if i == 35:
            dt = 0.5  # straggling step
        flagged |= mon.observe(i, dt)
    assert flagged
    assert 35 in mon.flagged


def test_trainer_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer rightly runs on it")
    data = DataConfig(vocab_size=64, seq_len=16, global_batch=4)
    trainer = Trainer(TINY, data, trainer_cfg=TrainerConfig(total_steps=1),
                      ckpt_cfg=CheckpointConfig(directory="unused", async_save=False))
    assert trainer.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer._init_state()


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

BF16 = "gemma2-2b"


def _assert_bits(port_tree, ref_tree):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    flat_r = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), \
            jax.tree_util.keystr(path)


def _stepped_port_state():
    """A bf16 smoke model's train state after one step, so the moments
    and the count are not zero."""
    cfg = port_configs.get_smoke(BF16).scaled(dtype="bfloat16")
    state = init_train_state(init_params(cfg, device="cpu", seed=4))
    batch = to_device(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                             global_batch=2)).batch_at(0), "cpu")
    state, _ = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=1))(state, batch)
    return cfg, state


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, async_save):
    """A train state saved by the port restores in
    ``repro.checkpoint.CheckpointStore`` into the reference's own layout
    (``{"params", "opt": {"m", "v", "count"}}``), every leaf bit for bit,
    bf16 weights included; the manifest's tree is the reference's
    ``PyTreeDef``."""
    cfg, state = _stepped_port_state()
    CheckpointStore(CheckpointConfig(directory=str(tmp_path), async_save=async_save)).save(
        3, train_state_tree(state))
    rcfg = ref_configs.get_smoke(BF16).scaled(dtype="bfloat16")
    params = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
    like = {"params": params, "opt": ref_init_opt_state(params)}
    restored, step = RefCheckpointStore(RefCheckpointConfig(directory=str(tmp_path))).restore(like)
    assert step == 3
    assert jax.tree_util.tree_leaves(restored)[-1].dtype == jnp.bfloat16
    _assert_bits(train_state_to_reference(state), restored)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(like))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A train state saved by the reference (bf16 weights, f32 moments
    after one AdamW step) restores through the port's store into a port
    train state, in place: every leaf bit for bit, and the weights the
    same ``Parameter`` objects as before."""
    rcfg = ref_configs.get_smoke(BF16).scaled(dtype="bfloat16")
    params = ref_models.init_params(rcfg, jax.random.PRNGKey(5))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    params, opt, _ = ref_adamw_update(params, grads, ref_init_opt_state(params),
                                      RefOptimizerConfig(lr=1e-2, warmup_steps=1))
    ref_state = {"params": params, "opt": opt}
    RefCheckpointStore(RefCheckpointConfig(directory=str(tmp_path), async_save=False)).save(
        9, ref_state)

    cfg = port_configs.get_smoke(BF16).scaled(dtype="bfloat16")
    state = init_train_state(LM(cfg, "cpu"))
    before = list(state["params"].parameters())
    restored, step = CheckpointStore(CheckpointConfig(directory=str(tmp_path))).restore(
        train_state_tree(state))
    assert step == 9
    load_train_state(state, restored)
    assert all(a is b for a, b in zip(before, state["params"].parameters()))
    assert int(state["opt"]["count"]) == 1
    _assert_bits(train_state_to_reference(state), jax.tree.map(np.asarray, ref_state))


def test_train_state_round_trip_is_exact():
    """Reference train state -> port -> reference, bit for bit, for a
    hybrid model (stacked ``inner`` layers inside ``segments``)."""
    rcfg = ref_configs.get_smoke("zamba2-7b")
    params = jax.jit(ref_models.init_params, static_argnums=0)(rcfg, jax.random.PRNGKey(1))
    grads = jax.tree.map(lambda p: jnp.full_like(p, -0.02), params)
    params, opt, _ = jax.jit(lambda p, g, o: ref_adamw_update(
        p, g, o, RefOptimizerConfig(lr=1e-2, warmup_steps=1)))(params, grads,
                                                                ref_init_opt_state(params))
    tree = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    state = train_state_from_reference(port_configs.get_smoke("zamba2-7b"), tree, "cpu")
    _assert_bits(train_state_to_reference(state), tree)


# ---------------------------------------------------------------------------
# The examples on the CPU
# ---------------------------------------------------------------------------

def _run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
                           *args], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_train_example_runs_on_the_cpu(tmp_path):
    """``examples/train_lm_torch.py`` at the tiny preset with a failure at
    step 9: one restart, and the lines the reference example prints."""
    lines = _run_example("train_lm_torch.py", "--preset", "tiny", "--steps", "12",
                         "--batch", "2", "--seq", "32", "--fail-at", "9",
                         "--ckpt-dir", str(tmp_path))
    assert "done: 12 steps, restarts=1" in lines
    assert any(l.startswith("loss: first=") for l in lines)
    assert any(l.startswith("step time (Tukey-filtered): ") and "95% CI" in l for l in lines)


def test_compressed_dp_example_runs_on_the_cpu():
    lines = _run_example("compressed_dp_torch.py")
    assert lines[0].startswith("wire volume: fp32 ") and "x reduction" in lines[0]
    assert lines[1].startswith("final loss: fp32 ")
    assert lines[2].startswith("Wilcoxon on last-8 losses: p=")
