"""Render the §Dry-run / §Roofline tables of EXPERIMENTS.md from the JSON
records written by ``repro_torch.launch.dryrun`` (a copy of the JAX
package's ``repro.launch.report`` on the port's registry: the same records
give the same text).

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_single.json
"""

from __future__ import annotations

import argparse
import json

from ..configs import ARCHS, SHAPES, applicable_shapes, get_config


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def roofline_table(records: list[dict]) -> str:
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    lines = [
        "| arch | shape | mesh | t_compute [s] | t_memory [s] | t_collective [s] "
        "| bottleneck | MODEL_FLOPS | useful ratio | roofline frac | "
        "mem/dev GiB (arg+tmp) | compile [s] |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    n_cells = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        app = applicable_shapes(cfg)
        for shape in SHAPES:
            for mesh in ("16x16", "2x16x16"):
                r = recs.get((arch, shape, mesh))
                if shape not in app:
                    if mesh == "16x16":
                        lines.append(
                            f"| {arch} | {shape} | — | — | — | — | *skipped:"
                            f" quadratic attention at 524k (DESIGN.md §4)* "
                            f"| — | — | — | — | — |")
                    continue
                if r is None:
                    lines.append(f"| {arch} | {shape} | {mesh} | MISSING "
                                 f"| | | | | | | | |")
                    continue
                n_cells += 1
                mem = r.get("memory_per_device", {})
                memstr = (f"{fmt_bytes(mem.get('argument_bytes', 0))}+"
                          f"{fmt_bytes(mem.get('temp_bytes', 0))}")
                lines.append(
                    f"| {arch} | {shape} | {mesh} "
                    f"| {r['t_compute']:.4f} | {r['t_memory']:.4f} "
                    f"| {r['t_collective']:.4f} | {r['bottleneck']} "
                    f"| {r['model_flops_global']:.2e} "
                    f"| {r['useful_flops_ratio']:.3f} "
                    f"| {r['roofline_fraction']:.4f} "
                    f"| {memstr} | {r['compile_seconds']:.0f} |")
    lines.append(f"\n({n_cells} compiled cells rendered)")
    return "\n".join(lines)


def collectives_table(records: list[dict]) -> str:
    lines = ["| arch | shape | mesh | collective ops | collective GiB/dev |",
             "|---|---|---|---|---|"]
    for r in sorted(records, key=lambda r: -r["collective_bytes_per_device"]):
        ops = " ".join(f"{k}:{v}" for k, v in sorted(r["collective_ops"].items()))
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {ops} "
                     f"| {r['collective_bytes_per_device'] / 2**30:.2f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    ap.add_argument("--collectives", action="store_true")
    args = ap.parse_args()
    records = []
    for f in args.files:
        with open(f) as fh:
            records.extend(json.load(fh))
    print(roofline_table(records))
    if args.collectives:
        print()
        print(collectives_table(records))


if __name__ == "__main__":
    main()
