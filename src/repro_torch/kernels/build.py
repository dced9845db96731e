"""Build the port's CUDA kernels from the repository's sources at first use.

Each ``csrc/*.cu`` file has a plain C entry point. It is compiled with
``nvcc -shared`` for ``sm_90a`` (Hopper) into ``build/kernels/`` at the
repository root (listed in ``.gitignore``) and loaded with :mod:`ctypes`.
The library's name carries a hash of the source and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import time: the CPU tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "build_library", "nvcc_path"]

#: ``<repo>/build/kernels`` — ``src/repro_torch/kernels/build.py`` is three
#: levels below the repository root.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_OPT = ("-std=c++17", "-O3")
_LINK = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from source at first use")


def build_library(source: Path, defines: dict,
                  flags: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (once per content and flags) and load it.

    ``flags`` are the kernel's own code-generation flags (``sim_scan``
    builds with ``--fmad=false`` to round like its plain version; the
    attention and SSD kernels, held at tolerances, keep fused
    multiply-adds).

    Returns ``(library, log)``; ``log`` is what ``nvcc``/``ptxas`` printed
    when the library was built (registers, spills), or the saved log of an
    earlier build. Raises ``RuntimeError`` with the compiler's output when
    the build fails.
    """
    source = Path(source)
    flags = [*_ARCH, *_OPT, *flags, *_LINK,
             *(f"-D{k}={v}" for k, v in sorted(defines.items()))]
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    stem = f"{source.stem}-{key.hexdigest()[:16]}"
    lib_path = BUILD_DIR / f"lib{stem}.so"
    log_path = BUILD_DIR / f"{stem}.log"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc_path(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)     # atomic: a concurrent build loses nothing
    log = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(lib_path)), log
