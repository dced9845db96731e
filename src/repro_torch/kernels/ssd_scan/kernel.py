"""Wrapper of the Hopper SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

:func:`ssd_scan` takes x ``(b, s, h, p)``, dta ``(b, s, h)`` float32 and
B/C ``(b, s, n)``, with x, B and C in float32 or bfloat16, and returns y
like x. On CUDA tensors it launches the kernels on the current stream
(``C Bᵀ`` once per chunk, then the chunk walk of each p-tile of each
head), or raises; on CPU tensors it runs the plain version
(:func:`.ref.ssd_chunked`). There is no other path: a kernel that fails to
build or launch raises, it is never replaced by the plain version.

The kernels copy x, B and C with 16-byte ``cp.async``: each must have unit
stride over its last dimension, every other stride (of a dimension longer
than 1) a multiple of 16 bytes and a 16-byte aligned start; anything else
raises ``ValueError``. The kernels have no backward pass: a CUDA call that
autograd would want a gradient from raises
(:func:`repro_torch.kernels.refuse_grad`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import refuse_grad
from ..build import build_library
from .ref import ssd_chunked

__all__ = ["ssd_scan", "load_kernel", "check_kernel_layout", "p_tiles",
           "CHUNK_MAX", "P_TILE"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

#: The longest chunk the kernel holds in shared memory; a longer requested
#: chunk runs as chunks of this length (the chunked form is exact for any
#: chunk, so only rounding moves).
CHUNK_MAX = 64
#: Head-dim columns (rows of the state) per CTA of the chunk walk, chosen
#: by measurement (``tune.py``); a ragged last tile is masked.
P_TILE = 32
#: Dynamic shared memory one block may use on Hopper.
_SMEM_LIMIT = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def load_kernel(p_tile: int = P_TILE) -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernels; returns ``(lib, log)``."""
    lib, log = build_library(_SOURCE, {"SSD_P_TILE": p_tile})
    fn = lib.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_scan_scratch_floats.argtypes = [ctypes.c_int] * 3
    return lib, log


def p_tiles(p: int) -> tuple[int, int]:
    """``(P_TILE, n_tiles)``: the chunk walk's CTAs of one head cover head
    dims ``[i * P_TILE, min((i + 1) * P_TILE, p))`` for ``i < n_tiles``."""
    return P_TILE, -(-p // P_TILE)


def _check(x, dta, B, C):
    if x.dim() != 4 or dta.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"ssd_scan: x must be (b, s, h, p), dta (b, s, h), "
                         f"B/C (b, s, n); got {tuple(x.shape)}, "
                         f"{tuple(dta.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, _ = x.shape
    if dta.shape != (b, s, h) or B.shape != C.shape or B.shape[:2] != (b, s):
        raise ValueError(f"ssd_scan: shapes do not agree: x {tuple(x.shape)},"
                         f" dta {tuple(dta.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    for name, t in (("dta", dta), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")


def _strides(t) -> tuple[int, ...]:
    """t's strides but the last, with that of a dimension of length 1
    (never stepped over) replaced by 0."""
    return tuple(st if n > 1 else 0
                 for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def check_kernel_layout(x, dta, B, C) -> None:
    """Raise unless the kernels take these tensors. Checks types, widths
    and layout only, so it runs on tensors on any device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: the kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: B and C must have x's type {x.dtype}, "
                        f"got {B.dtype}, {C.dtype}")
    if dta.dtype != torch.float32:
        raise TypeError(f"ssd_scan: the kernel takes float32 dta, got "
                        f"{dta.dtype}")
    if x.shape[3] % 4 or B.shape[2] % 4:
        raise ValueError(f"ssd_scan: the kernel tiles by 4; head dim "
                         f"{x.shape[3]} and state dim {B.shape[2]} must be "
                         "multiples of 4")
    for name, t in (("x", x), ("dta", dta), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} must have unit stride over "
                             "its last dimension")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if (any(st * t.element_size() % 16 for st in _strides(t))
                or t.data_ptr() % 16):
            raise ValueError(f"ssd_scan: {name} must start 16-byte aligned "
                             f"and have strides that are multiples of 16 "
                             f"bytes (the kernels copy 16 bytes at a time); "
                             f"got strides {tuple(t.stride())}")


def ssd_scan(x, dta, B, C, *, chunk=256, head_group=8):
    """Chunked SSD scan; returns y ``(b, s, h, p)`` in x's type.

    ``head_group`` is accepted for the reference's signature: it was a
    TPU tiling choice, and the result does not depend on it. The kernels
    run chunks of ``min(chunk, s, CHUNK_MAX)`` steps. Counts each call
    that launches them in ``ssd_scan.launches``. Raises ``RuntimeError``
    on CUDA tensors when autograd would want a gradient through the call.
    """
    _check(x, dta, B, C)
    b, s, h, p = x.shape
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked(x, dta, B, C, max(1, min(chunk, s)))[0]
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    refuse_grad("ssd_scan", x, dta, B, C)
    check_kernel_layout(x, dta, B, C)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch(x, dta, B, C, y, min(chunk, s, CHUNK_MAX))
    ssd_scan.launches += 1
    return y


def _launch(x, dta, B, C, y, chunk, p_tile=P_TILE, stages=None) -> None:
    """Launch ``C Bᵀ`` and the chunk walk into ``y``. ``stages`` None takes
    two where they fit the shared memory, else one. ``p_tile`` and
    ``stages`` are the knobs ``tune.py`` measures."""
    b, s, h, p = x.shape
    n = B.shape[2]
    lib, _ = load_kernel(p_tile)
    dtype = _DTYPES[x.dtype]
    if stages is None:
        stages = 2 if lib.ssd_scan_smem_bytes(dtype, n, chunk, 2) <= _SMEM_LIMIT else 1
    smem = lib.ssd_scan_smem_bytes(dtype, n, chunk, stages)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: state dim {n} needs {smem} B of shared "
                         f"memory per block at chunk {chunk} and p-tile "
                         f"{p_tile}; the card has {_SMEM_LIMIT}")
    g = torch.empty(lib.ssd_scan_scratch_floats(b, s, chunk),
                    dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(*_strides(x), *dta.stride(),
                                       *_strides(B), *_strides(C),
                                       *y.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dta.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), g.data_ptr(), dtype, b, s, h, p, n, chunk, stages,
            strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")


ssd_scan.launches = 0
