"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``perfbench/configs/<name>.json``) and a traffic mix
(``perfbench/traffic/<name>.json``); each metric is read by
``perfbench/metrics/<name>.py``. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
under the profiler. The last line on standard output is one JSON object;
the numbers the correctness check compared, each beside its limit, end
standard error. A run exits non-zero, with no result line, where the cell
asks for more CUDA devices than there are, where the program cannot be
imported, where the configuration names no system module there is, or a number
its check compares without a limit, or where the JAX stack, the JAX
package or its benchmark is loaded once the check and the result's summary
are done, whenever it was loaded.

The configuration's ``system`` names the module that runs the cell,
``perfbench/systems/<system>.py`` (``sim_campaign`` where the key is
absent), so a cell of a new kind arrives as files. A system module
exports ``NUMBERS``, the names its check compares (each needs an entry in
the configuration's ``limits``), and ``System(cfg, traffic, seed, device,
tracer)`` with:

* ``setup()``: builds and warms every shape of the cell; returns the
  seconds of each step;
* ``run(seconds)``: the measured window; returns a dict that holds at
  least ``due`` and ``records`` (the operations asked for and delivered),
  ``wall_s`` and ``valid`` (read by ``valid_meas_per_s``) and whatever
  the cell's metric readers read. It may hold ``memory_peak_bytes``, the
  peak on the fullest card as the module measured it; without it the
  harness reads its own process's peak. The harness adds ``setup_s``,
  ``trace`` and, after the check, ``check_s`` and ``setup_parts``;
* ``check()``: once the window has closed, the numbers compared against
  the plain reference, a dict holding every name in ``NUMBERS``;
* ``summary(run, numbers)``: the result line's ``run`` object;
* ``tiny(cfg, traffic)`` (static): the cell cut to a size the CPU tests
  run in seconds, as new ``(cfg, traffic)``.

``correct`` is true where every number in ``NUMBERS`` is within its limit.
The harness checks the cell's ``chips`` against the device count. A module
that starts rank processes owns them: it starts them in ``setup`` or
``run`` and has ended and joined every one before ``check`` returns. The
harness's own peak and profiler see its own process only: such a module
reports the ranks' peak as ``run["memory_peak_bytes"]``, and no
``device_trace`` metric may list its cell until it merges the ranks' traces.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
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
#: The system module of a configuration without a ``system`` key.
DEFAULT_SYSTEM = "sim_campaign"


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


def system_module(cfg: dict):
    """The module a configuration's ``system`` names: ``perfbench/systems/<system>.py``."""
    name = cfg.get("system", DEFAULT_SYSTEM)
    if not (isinstance(name, str) and name.isidentifier()
            and (BENCH / "systems" / f"{name}.py").is_file()):
        fail(f"no system {name!r}: perfbench/systems/<system>.py not found")
    return importlib.import_module(f"perfbench.systems.{name}")


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
            trace: bool, device: str = "cuda", tolerate: frozenset = frozenset(),
            system=None) -> dict:
    """Run cell ``w`` and return its result line's object.
    ``device="cpu"``, ``tolerate`` (blocked modules that other tests
    loaded into the process before the run) and ``system`` (a system
    module in place of the one the configuration names) are for the
    harness's own tests only: the command refuses to run without a card,
    tolerates no blocked module, and takes the system module from the
    configuration."""
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
    from perfbench.check import verdict
    from perfbench.devtrace import Tracer

    mod = system or system_module(cfg)
    limits = cfg.get("limits", {})
    missing = [k for k in mod.NUMBERS if k not in limits]
    if missing:
        fail("the configuration has no limit for " + ", ".join(missing))
    tracer = Tracer(trace)
    system = mod.System(cfg, traffic, seed, device, tracer)
    t_imports = time.perf_counter() - T_START
    setup_parts = system.setup()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tracer.start()
    t_window = time.perf_counter()
    run = system.run(seconds)
    run["trace"] = tracer.stop()
    run["setup_s"] = t_window - T_START
    if "memory_peak_bytes" in run:
        peak = run["memory_peak_bytes"]
    else:
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

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
    run["check_s"] = time.perf_counter() - t_check
    run["setup_parts"] = dict(imports=t_imports, **setup_parts)
    # an operation is one the window asked the program for (a campaign's
    # record for the simulator); it failed where the program did not deliver it
    result = {"correct": verdict(numbers, limits, mod.NUMBERS), "attempted": run["due"],
              "failed": run["due"] - run["records"], "metrics": values, "device": dev}
    if tr is not None:
        top = sorted(tr.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr.idle_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:96], s] for n, s in top],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["run"] = system.summary(run, numbers)
    result["checks"] = {k: {"value": finite(numbers[k]), "limit": limits[k]} for k in mod.NUMBERS}
    # after the readers, the check and the summary, which may load modules
    found = [m for m in blocked_modules() if m not in tolerate]
    if found:
        fail("modules of the JAX stack or package were loaded: " + ", ".join(found), 5)
    print(json.dumps({k: result[k] for k in ("correct", "run")}), file=sys.stderr)
    for k in mod.NUMBERS:
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
