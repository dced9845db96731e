"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention` takes model layout, q ``(B, S, H, D)`` and k/v
``(B, T, Hkv, D)``, in float32 or bfloat16. On CUDA tensors it launches
the kernel on the current stream, or raises; on CPU tensors it runs the
plain version (:func:`.ref.flash_attention_ref`). There is no other path:
a kernel that fails to build or launch raises, it is never replaced by
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from ..build import build_library
from .ref import flash_attention_ref

__all__ = ["flash_attention", "load_kernel", "BLOCK_Q", "BLOCK_K",
           "HEAD_DIMS"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: The kernel's own tile: query rows per CTA and keys per shared-memory
#: tile. ``block_q``/``block_k`` of the call do not change it.
BLOCK_Q = 64
BLOCK_K = 64
#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NO_LIMIT = 1 << 40     # "no window" / "no kv_len" for the kernel's masks


def _clamp(x) -> int:
    return max(-_NO_LIMIT, min(_NO_LIMIT, int(x)))


@functools.lru_cache(maxsize=1)
def load_kernel() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernel; returns ``(lib, log)``."""
    lib, log = build_library(_SOURCE, {"FLASH_BLOCK_Q": BLOCK_Q,
                                       "FLASH_BLOCK_K": BLOCK_K})
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_float] * 2
                   + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p])
    return lib, log


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-d (model "
                         f"layout), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k/v must be (B, T, Hkv, D) "
                         f"matching q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {k.shape[2]} KV heads")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q "
                             f"on {q.device}")


def _check_kernel_layout(q, k, v):
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head "
                         f"dims {HEAD_DIMS}, got {q.shape[3]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(3) != 1 or any(st % 4 for st in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} must have unit stride "
                             "over head_dim, other strides a multiple of 4 "
                             "and a 16-byte aligned start (the kernel loads "
                             "four elements at a time)")


def flash_attention(q, k, v, *, causal=True, window=None, logit_cap=0.0,
                    q_offset=0, kv_len=None, block_q=512, block_k=512):
    """Attention in model layout; returns ``(B, S, H, D)`` in q's type.

    Same contract as :func:`.ref.flash_attention_ref`. ``window``,
    ``q_offset`` and ``kv_len`` are runtime integers. ``block_q`` and
    ``block_k`` are accepted for the reference's signature; the kernel
    tiles by :data:`BLOCK_Q` x :data:`BLOCK_K` whatever they are. Counts
    each kernel launch in ``flash_attention.launches``.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset,
                                   kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_kernel_layout(q, k, v)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    lib, _ = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, hkv, d, strides,
            1.0 / math.sqrt(d),
            float(logit_cap) if logit_cap and logit_cap > 0 else 0.0,
            int(bool(causal)), _clamp(q_offset),
            _NO_LIMIT if window is None else _clamp(window),
            _NO_LIMIT if kv_len is None else _clamp(kv_len), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
