"""The kernels' public entry points and the operations-under-test factory.

The port of the JAX package's ``repro.kernels.ops``. :func:`flash_attention`
and :func:`ssd_scan` take model-layout tensors and launch the hand-written
Hopper kernels on CUDA tensors (their plain versions on CPU tensors). The
reference's wrappers padded to block multiples and fell back to the jnp
oracle for shapes the Pallas grid could not tile and for traced decode
positions; here the kernels mask ragged tiles themselves and nothing is
traced, so no call with ``impl="cuda"`` ever runs the plain version on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .flash_attention.kernel import flash_attention
from .flash_attention.ref import flash_attention_ref
from .ssd_scan.kernel import ssd_scan
from .ssd_scan.ref import ssd_chunked

__all__ = ["flash_attention", "ssd_scan", "make_benchmark_op",
           "BENCHMARK_OPS", "IMPLS"]

BENCHMARK_OPS = ("flash_attention", "ssd_scan")
#: ``cuda``: the hand-written kernel; ``ref``: its plain PyTorch version,
#: the measured comparator of an A/B.
IMPLS = ("cuda", "ref")


def make_benchmark_op(op: str, impl: str = "cuda", *, seq: int,
                      batch: int = 1, heads: int = 4,
                      kv_heads: int | None = None, head_dim: int = 32,
                      state_dim: int = 16, dtype=torch.float32,
                      seed: int = 0, device="cuda"):
    """A nullary callable running one forward of ``op`` at sequence length
    ``seq`` — the operation-under-test factory of
    :class:`repro_torch.campaign.TorchKernelBackend`.

    ``impl="cuda"`` times the kernel, ``impl="ref"`` its plain version.
    The inputs are drawn with numpy in the reference's order and scale
    (``default_rng(seed + 7919 * seq)``; q, k, v for attention, x, dta, B,
    C for SSD), so one seed gives the reference's float32 inputs bit for
    bit; the callable exposes them as ``.inputs``. Block and chunk sizes
    are clamped as the reference clamps them (128 and 64 past those
    lengths, ``head_group = min(heads, 8)``); the kernels take any
    ``seq``, so no length is refused.
    """
    if op not in BENCHMARK_OPS:
        raise ValueError(f"unknown benchmark op {op!r}; one of {BENCHMARK_OPS}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    rng = np.random.default_rng(seed + 7919 * seq)
    kv_heads = heads if kv_heads is None else kv_heads

    def _t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0.0, scale, shape)).to(dtype).to(device)

    if op == "flash_attention":
        block = seq if seq <= 128 else 128
        q = _t(batch, seq, heads, head_dim)
        k = _t(batch, seq, kv_heads, head_dim)
        v = _t(batch, seq, kv_heads, head_dim)
        inputs = (q, k, v)
        if impl == "cuda":
            def call():
                return flash_attention(q, k, v, causal=True, block_q=block,
                                       block_k=block)
        else:
            def call():
                return flash_attention_ref(q, k, v, causal=True)
    else:
        chunk = seq if seq <= 64 else 64
        hg = heads if heads <= 8 else 8
        x = _t(batch, seq, heads, head_dim)
        dta = -torch.abs(_t(batch, seq, heads, scale=0.5)) - 0.05
        B = _t(batch, seq, state_dim)
        C = _t(batch, seq, state_dim)
        inputs = (x, dta, B, C)
        if impl == "cuda":
            def call():
                return ssd_scan(x, dta, B, C, chunk=chunk, head_group=hg)
        else:
            def call():
                return ssd_chunked(x, dta, B, C, chunk)[0]
    call.inputs = inputs
    return call
