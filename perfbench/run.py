"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``perfbench/configs/<name>.json``) and a traffic mix
(``perfbench/traffic/<name>.json``), which ``perfbench/systems/sim_campaign.py``
runs as campaigns of the program; each metric is read by
``perfbench/metrics/<name>.py``. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
under the profiler. The last line on standard output is one JSON object;
the numbers the correctness check compared, each beside its limit, end
standard error. A run exits non-zero, with no result line, where the cell
asks for more CUDA devices than there are, where the program cannot be
imported, or where the JAX stack, the JAX package or its benchmark is
loaded once the window has closed, whenever it was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
#: Top-level module names the port's benchmark must never load: the JAX
#: stack, the JAX package this repository ports, and its benchmark folder.
BLOCKED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        fail(f"{path.relative_to(ROOT)} not found")


def load_module(path: Path, name: str):
    if not path.exists():
        fail(f"{path.relative_to(ROOT)} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, name: str) -> tuple[dict, dict, dict, list]:
    """The cell's entry, configuration, traffic mix and metrics (each
    metric applies where it lists the cell, or everywhere without a list)."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        fail(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    metrics = {kind: [m for m in bench[kind] if name in m.get("workloads", [name])]
               for kind in ("end_to_end", "per_layer")}
    return w, cfg, traffic, metrics


def blocked_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))


def card_info(torch) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip().split(",")
        info.update(power_limit_w=float(out[0]), sm_clock_mhz=float(out[1]),
                    sm_clock_max_mhz=float(out[2]))
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def finite(x):
    """``x`` for the result line: JSON has no infinity."""
    return x if x == x and abs(x) != float("inf") else sys.float_info.max


def execute(w: dict, cfg: dict, traffic: dict, metrics: dict, seed: int, seconds: float,
            trace: bool, device: str = "cuda", tolerate: frozenset = frozenset()) -> dict:
    """Run cell ``w`` and return its result line's object.
    ``device="cpu"``, and ``tolerate`` (blocked modules that other tests
    loaded into the process before the run), are for the harness's own
    tests only: the command refuses to run without a card, and tolerates
    no blocked module."""
    import torch

    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < w["chips"]:
            fail(f"{w['name']} needs {w['chips']} CUDA device(s), found {have}", 3)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program cannot be imported from {ROOT / 'src'}: {e}", 4)
    from perfbench.check import NUMBERS, verdict
    from perfbench.devtrace import Tracer
    from perfbench.systems.sim_campaign import System

    tracer = Tracer(trace)
    system = System(cfg, traffic, seed, device, tracer)
    t_imports = time.perf_counter() - T_START
    setup_parts = system.setup()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tracer.start()
    t_window = time.perf_counter()
    run = system.run(seconds)
    run["trace"] = tracer.stop()
    run["setup_s"] = t_window - T_START
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    found = [m for m in blocked_modules() if m not in tolerate]
    if found:
        fail("modules of the JAX stack or package were loaded: " + ", ".join(found), 5)

    dev = card_info(torch) if device == "cuda" else {"platform": "cpu", "kind": "cpu"}
    dev.update(count=w["chips"], memory_peak_bytes=int(peak))
    tr = run["trace"]
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)

    values = {}
    for m in metrics["per_layer" if trace else "end_to_end"]:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = system.check()
    t_check = time.perf_counter() - t_check
    limits = cfg["limits"]
    # an operation is a record the campaigns were asked for; it failed where
    # the program did not deliver it (a record whose every call the window
    # scheme discarded is delivered, and read as empty_record_share)
    result = {"correct": verdict(numbers, limits), "attempted": run["due"],
              "failed": run["due"] - run["records"], "metrics": values, "device": dev}
    if tr is not None:
        top = sorted(tr.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr.idle_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:96], s] for n, s in top],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["run"] = {k: run[k] for k in ("wall_s", "campaigns", "records", "valid", "empty",
                                         "rows", "topup_calls", "dispatches", "span_s")}
    result["run"].update(sim_scan_launches=len(run["scan_shapes"]), check_s=t_check,
                         setup_parts=dict(imports=t_imports, **setup_parts),
                         **{k: numbers[k] for k in ("epochs_checked", "windows_checked",
                                                    "calls_checked", "flag_rows", "unpaired")})
    result["checks"] = {k: {"value": finite(numbers[k]), "limit": limits[k]} for k in NUMBERS}
    print(json.dumps({k: result[k] for k in ("correct", "run")}), file=sys.stderr)
    for k in NUMBERS:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build caches at fixed paths inside the checkout (the kernel's own is
    # repro_torch.kernels.build.BUILD_DIR, build/kernels)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    w, cfg, traffic, metrics = cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    result = execute(w, cfg, traffic, metrics, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
