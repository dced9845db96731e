"""Wrapper of the Hopper flash-attention kernels (``csrc/*.cu``).

:func:`flash_attention` takes model layout, q ``(B, S, H, D)`` and k/v
``(B, T, Hkv, D)``, in float32 or bfloat16. On CUDA tensors it launches
one of two kernels on the current stream, or raises; on CPU tensors it
runs the plain version (:func:`.ref.flash_attention_ref`). There is no
other path: a kernel that fails to build or launch raises, it is never
replaced by the plain version.

The three instances (:func:`kernel_instance`):

* ``tf32x3`` (``csrc/flash_attention_tf32.cu``): float32 at every head
  dim, on the tensor cores through ``mma.sync`` in 3xTF32 (each f32
  product as three TF32 products, within the reference's f32 bound).
  ``cp.async`` copies 16-byte pieces: strides a multiple of 4 elements, a
  16-byte aligned start.
* ``wgmma_bf16`` (``csrc/flash_attention_sm90.cu``): bf16 at head dims
  64, 128 and 256, on the tensor cores, fed by TMA. TMA wants 16-byte
  aligned starts and strides, so q, k and v must have unit stride over
  head_dim, every other stride (of a dimension longer than 1) a multiple
  of 8 elements and a 16-byte aligned start; anything else raises
  ``ValueError``.
* ``simt`` (``csrc/flash_attention.cu``): bf16 at head dims 16 and 32,
  on the CUDA cores (strides a multiple of 4 elements).

A head dim between the built ones (zamba2-7b's 112, deepseek-v2's MLA
128 + 64 = 192) runs at the next built dim (:func:`padded_head_dim`):
q, k and v are zero-padded, the scale stays ``1/sqrt(D)`` of the
unpadded D, and the output is sliced back to D. Zero columns change
neither ``q·k`` nor the softmax, so the result is the unpadded one.
Above 256 the wrapper raises. No kernel has a backward pass: a CUDA call
that autograd would want a gradient from raises
(:func:`repro_torch.kernels.refuse_grad`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import refuse_grad
from ..build import build_library
from .ref import flash_attention_ref

__all__ = ["flash_attention", "load_kernel", "load_kernel_sm90",
           "load_kernel_tf32", "kernel_instance", "check_kernel_layout",
           "padded_head_dim", "pad_head_dim", "BLOCK_Q", "BLOCK_K",
           "HEAD_DIMS", "WGMMA_HEAD_DIMS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "flash_attention.cu"
_SOURCE_SM90 = _CSRC / "flash_attention_sm90.cu"
_SOURCE_TF32 = _CSRC / "flash_attention_tf32.cu"

#: The CUDA-core kernel's own tile: query rows per CTA and keys per
#: shared-memory tile (the tensor-core kernels' are 128 and 64, or 32 for
#: f32 at head dim 256).
#: ``block_q``/``block_k`` of the call change neither.
BLOCK_Q = 64
BLOCK_K = 64
#: Head dims the kernels are built for.
HEAD_DIMS = (16, 32, 64, 128, 256)
#: Head dims at which bf16 runs on the tensor cores.
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_NO_LIMIT = 1 << 40     # "no window" / "no kv_len" for the kernel's masks


def _clamp(x) -> int:
    return max(-_NO_LIMIT, min(_NO_LIMIT, int(x)))


@functools.lru_cache(maxsize=1)
def load_kernel() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the CUDA-core kernel; returns
    ``(lib, log)``."""
    return _load(_SOURCE, "flash_attention_launch",
                 {"FLASH_BLOCK_Q": BLOCK_Q, "FLASH_BLOCK_K": BLOCK_K})


@functools.lru_cache(maxsize=1)
def load_kernel_sm90() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the bf16 tensor-core kernel; returns
    ``(lib, log)``."""
    return _load(_SOURCE_SM90, "flash_attention_sm90_launch", {})


@functools.lru_cache(maxsize=1)
def load_kernel_tf32() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the f32 (3xTF32) tensor-core kernel;
    returns ``(lib, log)``."""
    return _load(_SOURCE_TF32, "flash_attention_tf32_launch", {})


def _load(source, entry, defines) -> tuple[ctypes.CDLL, str]:
    """Build and load ``source``; every entry point takes (q, k, v, o, B,
    S, T, H, Hkv, D, strides, scale, cap, causal, q_offset, window,
    kv_len, stream)."""
    lib, log = build_library(source, defines)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_float] * 2
                   + [ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p])
    return lib, log


def kernel_instance(dtype, head_dim: int) -> str:
    """Which kernel a CUDA call launches: ``"tf32x3"`` for float32,
    ``"wgmma_bf16"`` for bf16 at :data:`WGMMA_HEAD_DIMS`, ``"simt"`` for
    bf16 at the smaller head dims."""
    if dtype == torch.float32:
        return "tf32x3"
    if head_dim in WGMMA_HEAD_DIMS:
        return "wgmma_bf16"
    return "simt"


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


def _strides(x) -> tuple[int, int, int]:
    """x's (batch, seq, head) strides, with the stride of a dimension of
    length 1 (never stepped over) replaced by head_dim, so that it passes
    the alignment rules whatever torch reports for it."""
    return tuple(st if n > 1 else x.shape[3]
                 for n, st in zip(x.shape[:3], x.stride()[:3]))


def padded_head_dim(d: int) -> int:
    """The built head dim a call at head dim ``d`` runs at: ``d`` itself
    when the kernels are built for it, else the next one up. Raises
    ``ValueError`` above the largest."""
    for built in HEAD_DIMS:
        if built >= d:
            return built
    raise ValueError(f"flash_attention: the kernel is built for head dims "
                     f"{HEAD_DIMS} (smaller ones run zero-padded to the next), "
                     f"got {d}")


def pad_head_dim(q, k, v) -> tuple:
    """q, k and v zero-padded along the head dim to
    :func:`padded_head_dim`, or as they are when the kernels are built for
    their head dim."""
    d = q.shape[3]
    extra = padded_head_dim(d) - d
    if not extra:
        return q, k, v
    return tuple(F.pad(x, (0, extra)) for x in (q, k, v))


def check_kernel_layout(q, k, v) -> str:
    """Raise unless the kernels take these tensors; returns the instance
    (:func:`kernel_instance`) a CUDA call would launch. Checks type, head
    dim and layout only, so it runs on tensors on any device."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel is built for head "
                         f"dims {HEAD_DIMS}, got {q.shape[3]}")
    instance = kernel_instance(q.dtype, q.shape[3])
    multiple = 8 if instance == "wgmma_bf16" else 4
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(3) != 1 or any(st % multiple for st in _strides(x))
                or x.data_ptr() % 16):
            why = {"wgmma_bf16": "TMA loads 16-byte rows",
                   "tf32x3": "cp.async copies 16-byte pieces",
                   "simt": "the kernel loads four elements at a time"}[instance]
            raise ValueError(f"flash_attention: {name} must have unit stride "
                             f"over head_dim, other strides a multiple of "
                             f"{multiple} elements and a 16-byte aligned "
                             f"start for the {instance} kernel ({why}); got "
                             f"strides {tuple(x.stride())}")
    return instance


def _kernel_args(q, k, v, o, *, scale, causal, window, logit_cap, q_offset,
                 kv_len) -> tuple:
    """The arguments every entry point takes, for tensors that passed
    :func:`check_kernel_layout`, on the current stream."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k),
                                       *_strides(v), *o.stride()[:3])
    masks = (scale,
             float(logit_cap) if logit_cap and logit_cap > 0 else 0.0,
             int(bool(causal)), _clamp(q_offset),
             _NO_LIMIT if window is None else _clamp(window),
             _NO_LIMIT if kv_len is None else _clamp(kv_len))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, t, h,
            hkv, d, strides, *masks, stream)


def flash_attention(q, k, v, *, causal=True, window=None, logit_cap=0.0,
                    q_offset=0, kv_len=None, block_q=512, block_k=512):
    """Attention in model layout; returns ``(B, S, H, D)`` in q's type.

    Same contract as :func:`.ref.flash_attention_ref`. ``window``,
    ``q_offset`` and ``kv_len`` are runtime integers. ``block_q`` and
    ``block_k`` are accepted for the reference's signature; the kernels
    tile by their own sizes whatever they are. On CUDA tensors, float32
    launches the 3xTF32 tensor-core kernel (``tf32x3``), bf16 at head dims
    64, 128 and 256 the bf16 tensor-core kernel (``wgmma_bf16``), and bf16
    at head dims 16 and 32 the CUDA-core kernel (``simt``); a head dim in
    between runs zero-padded to the next built one. Counts each launch in
    ``flash_attention.launches``, by instance in
    ``flash_attention.launches_by_instance``, and the padded ones in
    ``flash_attention.launches_padded``. Raises ``RuntimeError`` on CUDA
    tensors when autograd would want a gradient through the call.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, q_offset=q_offset,
                                   kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and any(isinstance(t, dtensor.DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention: a DTensor's data_ptr is not a device "
                        "pointer; launch on its local shards (attention_op does, "
                        "through local_map)")
    refuse_grad("flash_attention", q, k, v)
    d = q.shape[3]
    q, k, v = pad_head_dim(q, k, v)
    instance = check_kernel_layout(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o[..., :d]
    with torch.cuda.device(q.device):
        args = _kernel_args(q, k, v, o, scale=1.0 / math.sqrt(d), causal=causal,
                            window=window, logit_cap=logit_cap, q_offset=q_offset,
                            kv_len=kv_len)
        if instance == "tf32x3":
            err = load_kernel_tf32()[0].flash_attention_tf32_launch(*args)
        elif instance == "wgmma_bf16":
            err = load_kernel_sm90()[0].flash_attention_sm90_launch(*args)
        else:
            err = load_kernel()[0].flash_attention_launch(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention {instance} kernel launch "
                           f"failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_instance[instance] += 1
    if q.shape[3] != d:
        flash_attention.launches_padded += 1
    return o[..., :d]


flash_attention.launches = 0
flash_attention.launches_by_instance = {"tf32x3": 0, "wgmma_bf16": 0, "simt": 0}
flash_attention.launches_padded = 0
#: launches on the local shards of DTensors, added by
#: ``repro_torch.models.attention._on_local_shards`` from ``launches``
#: across its local calls; also in ``launches``
flash_attention.launches_sharded = 0
