"""Gradient compression with error feedback (cross-pod hop optimization).

The port of the JAX package's ``repro.optim.compress``, in torch ops (the
reference computes it outside any kernel too). ``compress_tree`` /
``decompress_tree`` implement int8 blockwise quantization with an
error-feedback residual (1-bit-Adam style memory): the quantization error
of step ``t`` is added back into the gradient at ``t + 1``, keeping
SGD/Adam convergence unaffected to first order. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the quantized values and scales
are the reference's exactly. A tree is a dict (nested or flat) of
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "decompress_tree", "error_feedback_update", "BLOCK"]

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the flattened tensor:
    ``(q (n_blocks, BLOCK) int8, scale (n_blocks, 1) float32)``."""
    flat = x.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:n].reshape(tuple(shape)).to(dtype)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compress_tree(grads):
    return _map(quantize_int8, grads)


def decompress_tree(compressed, like):
    return _map(lambda qs, g: dequantize_int8(qs[0], qs[1], g.shape, g.dtype),
                compressed, like)


def error_feedback_update(grads, residual):
    """(grads + residual) -> (quantized-communicable grads, their
    dequantized values, the new residual)."""
    if residual is None:
        residual = _map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    corrected = _map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    comp = compress_tree(corrected)
    decomp = decompress_tree(comp, corrected)
    new_residual = _map(lambda c, d: c - d, corrected, decomp)
    return comp, decomp, new_residual
