"""The port's sharding rules against the JAX package's, and sharded numerics.

``repro_torch.parallel``'s ``param_specs``, ``cache_specs`` and
``batch_specs`` must equal ``repro.parallel``'s leaf for leaf, for all ten
published configs at full width, on both production meshes (16x16 and
2x16x16) and in all three sharding modes. Both sides run on shape-only
meshes (``jax.sharding.AbstractMesh``, the port's ``AbstractMesh``) with
nothing allocated: the reference's leaves from ``jax.eval_shape``, the
port's on the ``meta`` device. A port weight's spec is the reference
leaf's without the leading stacked-layer ``None``\\ s; each port name's
reference path comes from ``repro_torch.convert.named_to_reference``.

One card cannot hold a multi-device mesh, so sharded numerics are checked
here on four gloo ranks on the CPU (mesh 2x2, spawned processes meeting
through a ``file://`` rendezvous): smoke gemma2-2b's and mamba2-1.3b's
prefill and decode with weights and cache distributed by the port's specs
give the unsharded logits within 1e-5 in f32, and a checkpoint saved
unsharded restores as DTensors holding the saved array's slices.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import steps as ref_steps
from repro.parallel import ShardingConfig as RefShardingConfig
from repro.parallel import batch_specs as ref_batch_specs
from repro.parallel import cache_specs as ref_cache_specs
from repro.parallel import param_specs as ref_param_specs
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.convert import named_to_reference
from repro_torch.launch.steps import abstract_cache, abstract_params, input_specs
from repro_torch.parallel import (P, AbstractMesh, ShardingConfig, batch_specs, cache_specs,
                                  local_shape, param_specs, placements, sanitize)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("tp", "fsdp_tp", "dp")


def _meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)


@functools.cache
def _ref_params(arch):
    return ref_steps.abstract_params(ref_config(arch))


def _walk(ref_tree, path):
    for k in path:
        ref_tree = ref_tree[getattr(k, "key", getattr(k, "idx", None))]
    return ref_tree


def _spec_tree(tree):
    """A spec tree (either package's) as nested dicts and lists of tuples."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh, mode):
    ref_mesh, port_mesh = _meshes(mesh)
    cfg = get_config(arch)
    model = abstract_params(cfg)
    names = [n for n, _ in model.named_parameters()]
    ref = ref_param_specs(_ref_params(arch), ref_config(arch), ref_mesh,
                          RefShardingConfig(mode=mode))
    port = param_specs(model, cfg, port_mesh, ShardingConfig(mode=mode))
    assert set(port) == set(names)
    # each port weight's index, laid out as the reference's stacked leaves
    index = named_to_reference(model, {n: torch.tensor(i) for i, n in enumerate(names)})
    seen = 0
    for path, ids in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), index)):
        ref_spec = tuple(_walk(ref, path))
        lead = ids.ndim
        ref_spec = ref_spec + (None,) * (lead + len(port[names[int(ids.flat[0])]])
                                         - len(ref_spec))
        assert ref_spec[:lead] == (None,) * lead          # stacked layers never shard
        for i in ids.reshape(-1):
            assert tuple(port[names[int(i)]]) == ref_spec[lead:], (names[int(i)], path)
            seen += 1
    assert seen == len(names)


CACHE_CASES = [(a, "decode_32k") for a in ARCHS] + \
    [(a, "long_500k") for a in ("mamba2-1.3b", "zamba2-7b")]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CACHE_CASES)
def test_cache_specs_equal_reference(arch, shape, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    s = SHAPES[shape]
    ref_cache = ref_steps.abstract_cache(ref_config(arch), s.global_batch, s.seq_len)
    ref = ref_cache_specs(ref_config(arch), ref_mesh, ref_cache, RefShardingConfig())
    cache = abstract_cache(get_config(arch), s.global_batch, s.seq_len)
    port = cache_specs(get_config(arch), port_mesh, cache, ShardingConfig())
    assert _spec_tree(port) == _spec_tree(ref)


BATCH_CASES = [(a, s) for a in ARCHS for s in applicable_shapes(get_config(a))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", BATCH_CASES)
def test_batch_specs_equal_reference(arch, shape, mesh):
    ref_mesh, port_mesh = _meshes(mesh)
    ref_inputs = ref_steps.input_specs(ref_config(arch), REF_SHAPES[shape])
    inputs = input_specs(get_config(arch), SHAPES[shape])
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in inputs.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_inputs.items()}
    assert all(v.device.type == "meta" for v in inputs.values())
    assert _spec_tree(batch_specs(port_mesh, inputs)) == \
        _spec_tree(ref_batch_specs(ref_mesh, ref_inputs))


def test_placements_tuple_entry_spans_two_mesh_dims():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    assert placements(P(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="used twice"):
        placements(P("model", "model"), mesh)
    assert local_shape((256, 64, 32), P(("pod", "data"), None, "model"), mesh) == (8, 64, 2)


def test_sanitize_drops_what_the_mesh_does_not_divide():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    # mamba2's vocab 50280 does not split 16 ways; 2560 does
    assert sanitize(P("model", None), (50280, 2560), mesh) == P(None, None)
    assert sanitize(P(None, "model"), (50280, 2560), mesh) == P(None, "model")
    # a tuple entry needs the product of its axes (32) to divide
    assert sanitize(P(("pod", "data")), (16, 4), mesh) == P(None, None)
    assert sanitize(P(("pod", "data")), (64, 4), mesh) == P(("pod", "data"), None)
    # a short spec is padded with None to the tensor's rank
    assert sanitize(P("data"), (32, 5, 7), mesh) == P("data", None, None)


_RANKS = textwrap.dedent(r'''
    import json, os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, world, rdv, out):
        dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                                world_size=world)
        try:
            run(rank, out)
        finally:
            dist.destroy_process_group()

    def names(t):
        return [type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
                for p in t.placements]

    def rel(a, b):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        return float((a - b).abs().max() / b.abs().max())

    def model_run(arch, mesh):
        import copy
        import numpy as np
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_smoke
        from repro_torch.launch import make_prefill_step
        from repro_torch.models import decode_step, init_cache, init_params
        from repro_torch.parallel import batch_specs, cache_specs, distribute, param_specs

        cfg = get_smoke(arch)
        plain = init_params(cfg, device="cpu", seed=0)
        model = distribute(copy.deepcopy(plain), param_specs(plain, cfg, mesh), mesh)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int64))
        res = {"n_dtensor": sum(isinstance(p, DTensor) for p in model.parameters()),
               "n_params": sum(1 for _ in plain.parameters())}

        # prefill step: the whole sequence
        batch = {"tokens": toks}
        want = make_prefill_step(cfg)(plain, batch)
        got = make_prefill_step(cfg)(model, distribute(batch, batch_specs(mesh, batch), mesh))
        res["prefill"] = rel(got, want)

        # decode: the 8 tokens one at a time, a cache distributed by its specs
        cache = init_cache(cfg, 2, 12, device="cpu")
        dcache = distribute(init_cache(cfg, 2, 12, device="cpu"),
                            cache_specs(cfg, mesh, cache), mesh)
        first = dcache["segments"][0]
        res["cache_placements"] = names(first["k"] if "k" in first else first["state"])
        errs = []
        for i in range(8):
            tok = toks[:, i:i + 1]
            want, cache = decode_step(cfg, plain, cache, tok)
            dtok = distribute({"t": tok}, batch_specs(mesh, {"t": tok}), mesh)["t"]
            got, dcache = decode_step(cfg, model, dcache, dtok)
            errs.append(rel(got, want))
        res["decode"] = errs
        key = "k" if "k" in first else "state"
        res["cache"] = rel(dcache["segments"][0][key], cache["segments"][0][key])
        return res

    def run(rank, out):
        from repro_torch.checkpoint import CheckpointConfig, CheckpointStore
        from repro_torch.launch import make_local_mesh
        from repro_torch.models.common import split_dim
        from repro_torch.parallel import P, distribute

        torch.manual_seed(0)
        mesh = make_local_mesh(2, 2)
        res = {"rank": rank}
        for arch in ("gemma2-2b", "mamba2-1.3b"):
            res[arch] = model_run(arch, mesh)

        # split_dim gathers a dim the mesh does not split into whole pieces
        x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
        dx = distribute({"x": x}, {"x": P(None, None, "model")}, mesh)["x"]
        sx = split_dim(dx, 2, (1, 8))
        res["split"] = bool(torch.equal(sx.full_tensor(), x.reshape(2, 3, 1, 8)))

        # an unsharded checkpoint restored onto this mesh
        store = CheckpointStore(CheckpointConfig(directory=os.path.join(out, "ckpt"),
                                                 async_save=False))
        state = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
                 "step": torch.tensor(3, dtype=torch.int32)}
        if rank == 0:
            store.save(11, state)
        dist.barrier()
        shardings = {"w": (mesh, P("data", "model")), "step": (mesh, P())}
        restored, step = store.restore({k: torch.zeros_like(v) for k, v in state.items()},
                                       shardings=shardings)
        coord = mesh.get_coordinate()
        w = restored["w"]
        res["ckpt"] = dict(
            step=step, placements=names(w),
            local=bool(torch.equal(w.to_local(), state["w"][2 * coord[0]:2 * coord[0] + 2,
                                                            2 * coord[1]:2 * coord[1] + 2])),
            full=bool(torch.equal(w.full_tensor(), state["w"])),
            step_value=int(restored["step"].full_tensor()))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)

    if __name__ == "__main__":
        out = sys.argv[1]
        mp.start_processes(worker, args=(4, os.path.join(out, "rdv"), out), nprocs=4,
                           start_method="spawn", join=True)
''')


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Four gloo ranks on the CPU, mesh 2x2, each writing what it saw."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script), str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("arch,cache_placements", [
    ("gemma2-2b", ["Shard(1)", "Shard(3)"]),       # batch over data, 2 KV heads over model
    ("mamba2-1.3b", ["Shard(1)", "Shard(2)"]),     # batch over data, SSM heads over model
])
def test_sharded_prefill_and_decode_match_unsharded_on_gloo_ranks(gloo_ranks, arch,
                                                                  cache_placements):
    for rank in gloo_ranks:
        res = rank[arch]
        assert res["n_dtensor"] == res["n_params"]
        assert res["prefill"] <= 1e-5, res
        assert max(res["decode"]) <= 1e-5, res
        assert res["cache"] <= 1e-5, res
        assert res["cache_placements"] == cache_placements


def test_split_dim_gathers_what_the_mesh_does_not_divide(gloo_ranks):
    assert all(rank["split"] for rank in gloo_ranks)


def test_unsharded_checkpoint_restores_as_dtensors(gloo_ranks):
    """The counterpart of the reference's elastic restore to another mesh."""
    for res in gloo_ranks:
        ck = res["ckpt"]
        assert ck["step"] == 11 and ck["step_value"] == 3
        assert ck["placements"] == ["Shard(0)", "Shard(1)"]
        assert ck["local"] and ck["full"]
