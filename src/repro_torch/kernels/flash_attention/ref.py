"""Plain PyTorch version of the flash-attention kernel.

A line-for-line counterpart of the JAX package's oracle
``repro.kernels.flash_attention.ref.flash_attention_ref``: grouped-query
attention in model layout with optional causal mask, sliding window, logit
soft-cap, query-position offset (decode) and KV-length mask. It builds the
whole ``(B, Hkv, G, S, T)`` f32 logit tensor; the kernel never does.

Fully masked rows come out 0, as in the oracle.
"""

from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q, k, v, *, causal=True, window=None, logit_cap=0.0,
                        q_offset=0, kv_len=None, scale=None):
    """q: (B, S, H, D); k/v: (B, T, Hkv, D). Returns (B, S, H, D).
    ``scale`` multiplies the logits; ``None`` is ``1/sqrt(D)`` (a caller
    that zero-pads the head dim passes the unpadded one's)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) * scale
    if logit_cap and logit_cap > 0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    qpos = torch.arange(s, device=q.device) + q_offset
    kpos = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    logits = torch.where(mask[None, None, None], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully-masked rows
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v)
    return out.reshape(b, s, h, d)
