"""The port's dry run: op-level cost analysis, roofline math, the tables,
and cells through ``lower_cell``.

One card cannot hold a 256-rank mesh, so the cells run over a fake process
group (``repro_torch.launch.mesh.fake_world``) with every tensor on the
``meta`` device. A process group is process-wide, so each fake world
runs in a subprocess, as ``tests/test_dryrun_infra.py`` runs its forced
host devices.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.launch import report as ref_report
from repro_torch.launch import report
from repro_torch.launch.mesh import H100
from repro_torch.launch.op_analysis import analyze_step
from repro_torch.launch.roofline import RooflineReport

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, timeout: int = 240) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _chain(w, x, n):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("n", [1, 4, 16])
def test_analyzer_counts_chained_matmuls_exactly(n):
    """The counterpart of the reference's while-loop calibration: n chained
    256x256 f32 products count n * 2 * 256**3 FLOPs, exactly."""
    w = torch.empty(256, 256, device="meta")
    x = torch.empty(256, 256, device="meta")
    cost, out = analyze_step(_chain, w, x, n)
    assert cost.flops == n * 2 * 256 ** 3
    assert out.shape == (256, 256) and not cost.collective_ops
    assert cost.argument_bytes == 2 * 256 * 256 * 4


def test_analyzer_bytes_grow_with_depth():
    x = torch.empty(128, 128, device="meta")
    b4 = analyze_step(_chain, x, x, 4)[0].bytes_accessed
    b16 = analyze_step(_chain, x, x, 16)[0].bytes_accessed
    assert b16 > 2 * b4
    # each product reads two 64 KiB operands and writes one, tanh one in, one out
    assert b4 == 4 * 5 * 128 * 128 * 4


def test_analyzer_counts_per_device_on_a_sharded_mesh():
    """A column- then row-parallel pair on a fake 4x2 mesh: 1/8 of the
    global FLOPs (DTensor's sharding propagation, which runs each op again
    on FakeTensors, is not counted) and one all-reduce of the local
    output's bytes."""
    out = _run("""
        import json, torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.mesh import fake_world, mesh_device_type
        from repro_torch.launch.op_analysis import analyze_step
        from repro_torch.parallel import P, distribute

        with fake_world(8):
            mesh = init_device_mesh(mesh_device_type(), (4, 2), mesh_dim_names=("data", "model"))
            meta = lambda *s: torch.empty(s, device="meta")
            t = distribute({"x": meta(256, 512), "w1": meta(512, 1024), "w2": meta(1024, 512)},
                           {"x": P("data", None), "w1": P(None, "model"),
                            "w2": P("model", None)}, mesh)

            def pair(x, w1, w2):
                y = torch.tanh(x @ w1) @ w2          # a pending sum over model
                return y.redistribute(mesh, [Shard(0), Replicate()])

            cost, y = analyze_step(pair, t["x"], t["w1"], t["w2"])
        print(json.dumps(dict(flops=cost.flops, ops=cost.collective_ops,
                              bytes=cost.collective_bytes_by_op, shape=list(y.shape),
                              arg=cost.argument_bytes, warnings=cost.warnings)))
    """)
    global_flops = 2 * 256 * 512 * 1024 * 2
    assert out["flops"] == global_flops / 8
    assert out["ops"] == {"all-reduce": 1}
    assert out["bytes"] == {"all-reduce": 64 * 512 * 4}      # the local (64, 512) output
    assert out["shape"] == [256, 512] and not out["warnings"]
    # x's rows over data (4), the weights over model (2)
    assert out["arg"] == (256 * 512 // 4 + 2 * 512 * 1024 // 2) * 4


def test_roofline_report_math_on_h100():
    r = RooflineReport(
        arch="a", shape="s", mesh="16x16", chips=256,
        flops_per_device=H100.PEAK_FLOPS_BF16 * 0.1, bytes_per_device=H100.HBM_BW,
        collective_bytes_per_device=H100.NIC_BW * 0.5, collective_ops={},
        collective_bytes_by_op={}, memory_per_device={},
        model_flops_global=H100.PEAK_FLOPS_BF16 * 0.1 * 256 * 0.75,
        model_params=int(1e9))
    assert abs(r.t_compute - 0.1) < 1e-12
    assert abs(r.t_memory - 1.0) < 1e-12
    assert abs(r.t_collective - 0.5) < 1e-12
    assert r.bottleneck == "memory" and r.step_time_bound == r.t_memory
    assert abs(r.useful_flops_ratio - 0.75) < 1e-12
    assert abs(r.roofline_fraction - 0.075) < 1e-12
    assert set(r.to_dict()) >= {"t_compute", "t_memory", "t_collective", "bottleneck",
                                "useful_flops_ratio", "roofline_fraction"}
    assert (H100.PEAK_FLOPS_BF16, H100.HBM_BW, H100.NIC_BW, H100.HBM_BYTES) == \
        (989.4e12, 3.35e12, 50e9, 80e9)


def _records():
    """Records as both packages' dry runs write them, with a missing cell,
    a skipped shape and two meshes."""
    def rec(arch, shape, mesh, scale, ops):
        return {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256,
                "t_compute": 0.0123 * scale, "t_memory": 0.5 * scale,
                "t_collective": 0.25 / scale, "bottleneck": "memory",
                "model_flops_global": 1.6e16 * scale, "useful_flops_ratio": 0.709,
                "roofline_fraction": 0.0754 * scale,
                "memory_per_device": {"argument_bytes": int(5e8 * scale),
                                      "temp_bytes": int(2e11 / scale)},
                "compile_seconds": 9.6 * scale,
                "collective_ops": ops, "collective_bytes_per_device": 4.3e10 * scale}
    return [rec("gemma2-2b", "train_4k", "16x16", 1.0, {"all-gather": 902, "all-reduce": 161}),
            rec("gemma2-2b", "train_4k", "2x16x16", 2.0, {"reduce-scatter": 3}),
            rec("mamba2-1.3b", "long_500k", "16x16", 0.5, {}),
            rec("mixtral-8x22b", "decode_32k", "2x16x16", 3.0, {"all-to-all": 7})]


def test_tables_render_the_reference_text():
    records = _records()
    assert report.roofline_table(records) == ref_report.roofline_table(records)
    assert report.collectives_table(records) == ref_report.collectives_table(records)
    assert "(4 compiled cells rendered)" in report.roofline_table(records)


def test_smoke_cell_through_lower_cell():
    """The reference's own 8-device cell: smoke gemma2-2b, a (8, 32) train
    batch, mesh 4x2, the train step (autograd through DTensors, AdamW)."""
    out = _run("""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import ShapeSpec, get_smoke
        from repro_torch.launch.dryrun import lower_cell
        from repro_torch.launch.mesh import fake_world, mesh_device_type

        with fake_world(8):
            mesh = init_device_mesh(mesh_device_type(), (4, 2), mesh_dim_names=("data", "model"))
            report, (state, metrics) = lower_cell(
                "gemma2-2b", ShapeSpec("t", 32, 8, "train"), mesh=mesh,
                cfg=get_smoke("gemma2-2b"))
            d = report.to_dict()
            wq = state["params"].segments[0][0].attn.wq
            d["weight_placements"] = [str(p) for p in wq.placements]
            d["loss_shape"] = list(metrics["loss"].shape)
        print(json.dumps(d))
    """)
    assert out["flops_per_device"] > 0 and out["chips"] == 8 and out["mesh"] == "4x2"
    assert out["collective_bytes_per_device"] > 0
    assert out["memory_per_device"]["peak_bytes"] > out["memory_per_device"]["argument_bytes"] > 0
    assert len(out["weight_placements"]) == 2 and out["loss_shape"] == []


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_smoke_moe_train_cell_through_lower_cell(arch):
    """The MoE train step on meta DTensors, mesh 4x2: S 128 > 64 takes the
    grouped dispatch that train_4k takes, and the routed experts' backward
    runs on local shards (DTensor's own backward of the expert products
    hands ``aten.view`` a transposed gradient and fails)."""
    out = _run(f"""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import ShapeSpec, get_smoke
        from repro_torch.launch.dryrun import lower_cell
        from repro_torch.launch.mesh import fake_world, mesh_device_type

        with fake_world(8):
            mesh = init_device_mesh(mesh_device_type(), (4, 2), mesh_dim_names=("data", "model"))
            report, (state, metrics) = lower_cell(
                "{arch}", ShapeSpec("t", 128, 8, "train"), mesh=mesh,
                cfg=get_smoke("{arch}"))
            d = report.to_dict()
            moe = next(m for m in state["params"].modules() if type(m).__name__ == "MoE")
            names = lambda t: [type(p).__name__ + str(getattr(p, "dim", "")) for p in t.placements]
            d["w_gate"], d["grad"] = names(moe.w_gate), names(moe.w_gate.grad)
            d["loss_shape"] = list(metrics["loss"].shape)
        print(json.dumps(d))
    """)
    assert out["flops_per_device"] > 0 and out["chips"] == 8 and out["mesh"] == "4x2"
    assert out["collective_bytes_per_device"] > 0 and out["loss_shape"] == []
    # FSDP over data, the experts over model (E = 4 and 8 divide 2)
    assert out["w_gate"] == ["Shard1", "Shard0"]
    assert len(out["grad"]) == 2


def test_full_width_prefill_cell_on_the_production_mesh(tmp_path):
    """gemma2-2b prefill_32k on 16x16 (a fake world of 256 ranks) through
    the CLI: the step runs at full width on meta DTensors."""
    out_json = tmp_path / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "gemma2-2b", "--shape", "prefill_32k", "--out", str(out_json)],
                          env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[dryrun] gemma2-2b x prefill_32k mesh=16x16" in proc.stdout
    assert "(HBM 80 GB)" in proc.stdout and "ALL 1 CELLS PASSED" in proc.stdout
    (rec,) = json.loads(out_json.read_text())
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        ("gemma2-2b", "prefill_32k", "16x16", 256)
    assert rec["flops_per_device"] > 0 and rec["collective_ops"]
    # 2.6 B bf16 weights over 256 ranks, the (32, 32768) tokens over 16
    assert 0 < rec["memory_per_device"]["argument_bytes"] < 2 ** 30
