"""Nothing the benchmark runs may load JAX, the JAX package this repository
ports (``repro``) or its benchmark folder (``benchmarks``). Names are
compared whole, by top-level module: ``repro_torch`` is the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.tiny import ROOT, harness

BLOCKED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_a_blocked_module():
    assert set(harness.BLOCKED) == BLOCKED
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert len(files) > 10
    found = {(f.relative_to(ROOT).as_posix(), name) for f in files for name in _imports(f)
             if name in BLOCKED}
    assert not found


SCRIPT = r"""
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from perfbench.tests.tiny import run_tiny
from perfbench.run import blocked_modules
for name in ("hca512-long", "drift512-paper"):
    res = run_tiny(name, trace=name == "drift512-paper")
    assert res["correct"], res["checks"]
assert blocked_modules() == [], blocked_modules()
print("ISOLATED", sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""


def test_a_run_loads_no_blocked_module_even_when_they_cannot_load():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED []" in proc.stdout


# The command's own path (``main``), on the CPU: ``execute`` is wrapped only
# to cut the cell down and run it there, with the arguments ``main`` gives.
COMMAND = r"""
import sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
if sys.argv[2] == "stub":
    sys.path.insert(0, sys.argv[3])
    import jax  # a stub, loaded before the run as a site hook would load it
from perfbench import run as harness
from perfbench.tests import tiny

execute = harness.execute

def on_cpu(w, cfg, traffic, metrics, *args, **kw):
    return execute(*tiny.tiny(w["name"]), *args, device="cpu", **kw)

harness.execute = on_cpu
harness.main(["--workload", "hca512-paper", "--seed", "5", "--seconds", "0.2", "--trace", "0"])
"""


@pytest.mark.parametrize("stub", ["stub", "none"])
def test_the_command_refuses_a_blocked_module_loaded_before_it(tmp_path, stub):
    """A blocked module in the process fails the run whenever it was
    loaded: exit 5, no result line, the module named on standard error.
    Without it the same run prints its result."""
    (tmp_path / "jax.py").write_text("STUB = True\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", COMMAND, str(ROOT), stub, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if stub == "stub":
        assert proc.returncode == 5 and '"correct"' not in proc.stdout, proc.stderr[-3000:]
        assert "were loaded: jax" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True


def test_only_the_benchmark_files_cannot_run(tmp_path):
    """A checkout of ``BENCHMARK.json`` and ``perfbench/`` alone has no
    program to measure: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from perfbench.tests.tiny import run_tiny; run_tiny('hca512-long')")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout
    assert "cannot be imported" in proc.stderr
