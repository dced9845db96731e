"""Multi-pod dry run: show that the distribution config is coherent
without the hardware (the counterpart of the JAX package's
``repro.launch.dryrun``).

For every (architecture x input shape) cell this runs the step (train,
prefill or decode) once on the production mesh (16x16, 256 ranks, and
2x16x16, 512) with abstract inputs: the weights, optimizer state, cache
and batch on ``meta`` (nothing allocated), placed as DTensors by the
port's sharding rules over a fake process group (:func:`fake_world`, one
process playing rank 0). :mod:`~repro_torch.launch.op_analysis` counts
rank 0's FLOPs, bytes, collectives and memory as the step runs, and the
cell's :class:`~repro_torch.launch.roofline.RooflineReport` against the
H100 record is printed and appended to a JSON file. Attention runs the
plain path (``impl="ref"``), as the reference lowers
``attention_reference`` on forced host devices. One card cannot hold
these meshes: this checks layouts and counts, not numbers.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCHS, SHAPES, ShapeSpec, applicable_shapes, get_config
from ..parallel import P, ShardingConfig, batch_specs, cache_specs, distribute, param_specs
from .mesh import fake_world, make_production_mesh, mesh_device_type
from .op_analysis import analyze_step
from .roofline import roofline_from_cost
from .steps import (
    abstract_cache,
    abstract_params,
    abstract_train_state,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = ["model_flops", "lower_cell", "run_cell", "main"]


def model_flops(cfg, shape) -> tuple[float, int]:
    """(MODEL_FLOPS_global, N_params[active]) — 6*N*D train, 2*N*D inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens, n_active
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens, n_active
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens, n_active


def lower_cell(arch: str, shape_name, *, multi_pod: bool = False,
               sharding_mode: str = "fsdp_tp", remat: bool = True,
               mesh=None, cfg=None):
    """Run one (arch x shape x mesh) cell's step once on ``meta`` DTensors
    and count it; returns ``(report, the step's output)``.

    Wants an open process group: the production mesh's 256 or 512 ranks
    (:func:`fake_world`), or whatever ``mesh`` (a ``DeviceMesh``) spans.
    ``shape_name`` names one of ``SHAPES`` or is a ``ShapeSpec``; ``cfg``
    replaces ``arch``'s published config (a smoke config in the tests)."""
    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_desc = "x".join(str(s) for s in mesh.shape)
    chips = mesh.size()
    shcfg = ShardingConfig(mode=sharding_mode)

    specs = input_specs(cfg, shape)
    batch = distribute(specs, batch_specs(mesh, specs), mesh)

    t0 = time.time()
    if shape.kind == "train":
        state = abstract_train_state(cfg)
        p_specs = param_specs(state["params"], cfg, mesh, shcfg)
        opt_specs = {"m": p_specs, "v": p_specs, "count": P()}
        state = {"params": distribute(state["params"], p_specs, mesh),
                 "opt": distribute(state["opt"], opt_specs, mesh)}
        cost, out = analyze_step(make_train_step(cfg, remat=remat), state, batch)
    elif shape.kind == "prefill":
        params = abstract_params(cfg)
        distribute(params, param_specs(params, cfg, mesh, shcfg), mesh)
        cost, out = analyze_step(make_prefill_step(cfg, remat=remat, impl="ref"),
                                 params, batch)
    else:  # decode
        params = abstract_params(cfg)
        distribute(params, param_specs(params, cfg, mesh, shcfg), mesh)
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cache = distribute(cache, cache_specs(cfg, mesh, cache, shcfg), mesh)
        cost, out = analyze_step(make_decode_step(cfg, impl="ref"), params, cache, batch)
    dt = time.time() - t0

    mf, n_active = model_flops(cfg, shape)
    report = roofline_from_cost(
        cost, arch=arch, shape=shape.name, mesh_desc=mesh_desc, chips=chips,
        model_flops_global=mf, model_params=n_active, compile_seconds=dt)
    return report, out


def run_cell(arch, shape_name, multi_pod, args):
    """One cell in a fake world of its mesh's size; prints and returns its
    record."""
    from ..models.tuning import tuning_tag

    with fake_world(512 if multi_pod else 256):
        report, _ = lower_cell(
            arch, shape_name, multi_pod=multi_pod, sharding_mode=args.sharding,
            remat=not args.no_remat)
    d = report.to_dict()
    d["tuning"] = tuning_tag()
    d["donate"] = not args.no_donate
    d["mesh_device"] = mesh_device_type()
    mem = d["memory_per_device"]
    print(f"[dryrun] {arch} x {shape_name} mesh={d['mesh']} ({d['mesh_device']}) "
          f"run={d['compile_seconds']:.1f}s")
    print(f"  memory/device: args={mem.get('argument_bytes', 0)/2**30:.2f}GiB "
          f"peak={mem.get('peak_bytes', 0)/2**30:.2f}GiB "
          f"temp={mem.get('temp_bytes', 0)/2**30:.2f}GiB "
          f"(HBM 80 GB)")
    print(f"  flops/device={d['flops_per_device']:.3e} "
          f"bytes/device={d['bytes_per_device']:.3e} "
          f"coll_bytes/device={d['collective_bytes_per_device']:.3e}")
    print(f"  roofline terms [s]: compute={d['t_compute']:.4f} "
          f"memory={d['t_memory']:.4f} collective={d['t_collective']:.4f} "
          f"-> bottleneck={d['bottleneck']}")
    print(f"  MODEL_FLOPS={d['model_flops_global']:.3e} "
          f"useful_ratio={d['useful_flops_ratio']:.3f} "
          f"roofline_fraction={d['roofline_fraction']:.3f}")
    print(f"  collectives: {d['collective_ops']}")
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sharding", default="fsdp_tp",
                    choices=["tp", "fsdp_tp", "dp"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-donate", action="store_true",
                    help="recorded in each record; no effect: eager PyTorch has "
                         "no buffers to donate")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tune", default=None,
                    help="comma list of tuning knobs, e.g. "
                         "'ce_chunk=8,attn_additive_mask=1'")
    args = ap.parse_args(argv)

    if args.tune:
        from ..models.tuning import set_tuning

        kw = {}
        for item in args.tune.split(","):
            k, v = item.split("=")
            kw[k] = int(v) if v.isdigit() else v.lower() in ("true", "1", "yes")
        set_tuning(**kw)

    if args.all:
        cells = [(arch, shape_name) for arch in ARCHS
                 for shape_name in applicable_shapes(get_config(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all required")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    existing = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for rec in json.load(f):
                existing[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    results = list(existing.values())

    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            mesh_desc = "2x16x16" if mp else "16x16"
            if args.skip_existing and (arch, shape_name, mesh_desc) in existing:
                print(f"[dryrun] skip cached {arch} x {shape_name} {mesh_desc}")
                continue
            try:
                d = run_cell(arch, shape_name, mp, args)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"])
                           != (arch, shape_name, mesh_desc)]
                results.append(d)
            except Exception as e:      # the cell fails; the run goes on and exits 1
                traceback.print_exc()
                failures.append((arch, shape_name, mesh_desc, repr(e)[:200]))
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    if failures:
        print("\nFAILED CELLS:")
        for f4 in failures:
            print(" ", f4)
        raise SystemExit(1)
    print(f"\nALL {len(cells) * len(meshes)} CELLS PASSED")


if __name__ == "__main__":
    main()
