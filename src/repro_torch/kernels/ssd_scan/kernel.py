"""Wrapper of the Hopper SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

:func:`ssd_scan` takes x ``(b, s, h, p)``, dta ``(b, s, h)`` float32 and
B/C ``(b, s, n)``, with x, B and C in float32 or bfloat16, and returns y
like x. On CUDA tensors it launches the kernel on the current stream, or
raises; on CPU tensors it runs the plain version
(:func:`.ref.ssd_chunked`). There is no other path: a kernel that fails to
build or launch raises, it is never replaced by the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import build_library
from .ref import ssd_chunked

__all__ = ["ssd_scan", "load_kernel", "CHUNK_MAX"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

#: The longest chunk the kernel holds in shared memory; a longer requested
#: chunk runs as chunks of this length (the chunked form is exact for any
#: chunk, so only rounding moves).
CHUNK_MAX = 64
#: Dynamic shared memory one block may use on Hopper.
_SMEM_LIMIT = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def load_kernel() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernel; returns ``(lib, log)``."""
    lib, log = build_library(_SOURCE, {})
    fn = lib.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib, log


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


def _check_kernel_layout(x, dta, B, C):
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


def ssd_scan(x, dta, B, C, *, chunk=256, head_group=8):
    """Chunked SSD scan; returns y ``(b, s, h, p)`` in x's type.

    ``head_group`` is accepted for the reference's signature: it was a
    TPU tiling choice, and the result does not depend on it. The kernel
    runs chunks of ``min(chunk, s, CHUNK_MAX)`` steps. Counts each kernel
    launch in ``ssd_scan.launches``.
    """
    _check(x, dta, B, C)
    b, s, h, p = x.shape
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked(x, dta, B, C, max(1, min(chunk, s)))[0]
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _check_kernel_layout(x, dta, B, C)
    n = B.shape[2]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib, _ = load_kernel()
    chunk = min(chunk, s, CHUNK_MAX)
    smem = lib.ssd_scan_smem_bytes(p, n, chunk)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan: head dim {p} x state dim {n} needs "
                         f"{smem} B of shared memory per block at chunk "
                         f"{chunk}; the card has {_SMEM_LIMIT}")
    strides = (ctypes.c_longlong * 13)(*x.stride()[:3], *dta.stride(),
                                       *B.stride()[:2], *C.stride()[:2],
                                       *y.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dta.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), _DTYPES[x.dtype], b, s, h, p, n, chunk, strides,
            stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
