"""Shared model components: configs, norms, rotary embeddings, init helpers.

The port of the JAX package's ``repro.models.common``. Parameters live in
``nn.Module``s whose attribute names are the reference's pytree keys, and
a segment's layers are a ``ModuleList`` where the reference stacks them
under ``lax.scan``. Weight matrices keep the reference's ``(in, out)``
layout, so ``x @ w`` is the same product in both packages.

The reference's ``shard_hint`` is not ported: it is a no-op off a device
mesh, and on a mesh DTensor derives the activations' layouts from the
weights' (:mod:`repro_torch.parallel`). ``with_layer_axis`` (a ``vmap`` over
stacked layers) has no counterpart: the port draws each layer's weights
in turn.

The model runs on plain tensors and on DTensors (weights placed by
:func:`repro_torch.parallel.distribute`). Where a view splits a sharded
dim into pieces the mesh does not divide (8 heads over a 16-wide
``model`` axis), :func:`split_dim` gathers that dim first: XLA inserts
that resharding unasked, DTensor refuses the view. On plain tensors
every function here runs exactly as before.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "ModelConfig",
    "rms_norm",
    "rotary_embedding",
    "apply_rope",
    "softcap",
    "activation_fn",
    "dense_init",
    "embed_init",
    "cross_entropy_loss",
    "is_dtensor",
    "split_dim",
    "merge_dims",
]


@dataclass(frozen=True)
class ModelConfig:
    """One config dataclass covers every assigned architecture family; the
    per-arch modules read only the fields relevant to their family."""

    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1000
    head_dim: int | None = None     # default d_model // n_heads
    # --- attention pattern -------------------------------------------------
    window: int | None = None       # sliding-window size for local layers
    global_every: int = 0           # 0: all layers global; k: layer i is
                                    # global iff (i+1) % k == 0 (gemma3 5:1)
    attn_softcap: float = 0.0       # attention logit soft-capping (gemma2)
    final_softcap: float = 0.0      # final-logit soft-capping (gemma2)
    rope_theta: float = 10000.0
    act: str = "swiglu"             # swiglu | geglu
    glu: bool = True                # gated FFN (3 matrices) vs plain MLP (2)
    qk_norm: bool = False
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0               # routed-expert hidden size (deepseek)
    first_dense_layers: int = 0     # deepseek: first layer(s) stay dense
    # --- MLA (deepseek) ----------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0              # mamba2 heads (d_inner // head_dim)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0             # hybrid: shared attn block every k layers
    # --- embeddings / misc ---------------------------------------------------
    tie_embeddings: bool = True
    embed_scale: bool = False       # gemma multiplies embeddings by sqrt(D)
    # --- encoder-decoder -----------------------------------------------------
    n_encoder_layers: int = 0
    cross_attention: bool = False
    # --- modality frontend (stub) -------------------------------------------
    frontend: str | None = None     # 'vision' | 'audio'
    frontend_tokens: int = 0        # precomputed embedding positions per item
    dtype: str = "bfloat16"

    # --------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        """``dtype`` as a torch type (the reference's ``jdtype``)."""
        return getattr(torch, self.dtype)

    def is_global_layer(self, i: int) -> bool:
        if self.global_every < 0:
            return False          # all layers sliding-window (Mixtral SWA)
        if self.global_every == 0 or self.window is None:
            return True
        return (i + 1) % self.global_every == 0

    def global_flags(self) -> np.ndarray:
        return np.array([self.is_global_layer(i) for i in range(self.n_layers)])

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        return int(_param_count(self))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed)."""
        return int(_param_count(self, active_only=True))


# The analytic counts below are the reference's arithmetic, without its two
# dead expressions (an unused ``d_bc`` and a conditional whose branches are
# both ``cfg.d_ff``); the tests hold every count equal to the reference's.

def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    return (3 if cfg.glu else 2) * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    if cfg.kv_lora_rank:  # MLA
        d = cfg.d_model
        r = cfg.kv_lora_rank
        qr = cfg.q_lora_rank or d
        nh, hd, rd = cfg.n_heads, cfg.hd, cfg.rope_head_dim
        q = d * qr + qr * nh * (hd + rd)
        kv = d * (r + rd) + r * nh * (hd + hd)
        o = nh * hd * d
        return q + kv + o
    hd = cfg.hd
    return cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * cfg.d_model


def _ssm_params(cfg: ModelConfig) -> int:
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(1, d_inner // cfg.ssm_head_dim)
    # in_proj: z, x, B, C, dt ; out_proj
    in_proj = cfg.d_model * (2 * d_inner + 2 * cfg.ssm_state + nh)
    out_proj = d_inner * cfg.d_model
    return in_proj + out_proj + d_inner  # + conv/bias-ish small terms


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model  # embeddings (tied: counted once)
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    if cfg.family in ("ssm",):
        n += cfg.n_layers * _ssm_params(cfg)
        return n
    if cfg.family == "hybrid":
        n += cfg.n_layers * _ssm_params(cfg)
        n_attn = cfg.n_layers // max(1, cfg.attn_every)
        n += _attn_params(cfg)  # ONE shared attention block (zamba2)
        n += n_attn * 2 * cfg.d_model  # per-use norms
        return n
    layers = cfg.n_layers + cfg.n_encoder_layers
    attn = _attn_params(cfg)
    if cfg.n_experts:
        d_ff_routed = cfg.moe_d_ff or cfg.d_ff
        router = cfg.d_model * cfg.n_experts
        shared = cfg.n_shared_experts * _ffn_params(cfg, d_ff_routed)
        n_dense = cfg.first_dense_layers
        n_moe = cfg.n_layers - n_dense
        experts_total = cfg.n_experts * _ffn_params(cfg, d_ff_routed)
        experts_active = cfg.moe_top_k * _ffn_params(cfg, d_ff_routed)
        dense_ffn = _ffn_params(cfg, cfg.d_ff)
        n += n_dense * (attn + dense_ffn)
        n += n_moe * (attn + router + shared + (experts_active if active_only else experts_total))
        if cfg.cross_attention:
            n += cfg.n_layers * attn
        return n
    ffn = _ffn_params(cfg, cfg.d_ff)
    n += layers * (attn + ffn)
    if cfg.cross_attention:
        n += cfg.n_layers * attn  # decoder cross-attention blocks
    return n


# ---------------------------------------------------------------------------
# DTensor
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor's module: when
    it was never imported, nothing is one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def split_dim(t: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``t`` with ``dim`` split into ``sizes`` (a reshape). On a DTensor
    whose ``dim`` is sharded over mesh dims whose sizes multiply to a
    number that does not divide ``sizes[0]`` (gemma2-2b's 8 heads over a
    16-wide ``model`` axis), those mesh dims are gathered first."""
    dim = dim % t.dim()
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        mesh, places = t.device_mesh, list(t.placements)
        on = [i for i, pl in enumerate(places) if isinstance(pl, Shard) and pl.dim == dim]
        if sizes[0] % math.prod(mesh.size(i) for i in on):
            for i in on:
                places[i] = Replicate()
            t = t.redistribute(mesh, places)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


class _Merge(torch.autograd.Function):
    """A reshape merging two dims, whose backward splits the gradient with
    :func:`split_dim` (the gradient may come sharded where the forward's
    input was not)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.sizes = dim, tuple(t.shape[dim:dim + 2])
        return t.reshape(*t.shape[:dim], -1, *t.shape[dim + 2:])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None


def merge_dims(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dims ``dim`` and ``dim + 1`` merged (a reshape; heads
    back into the model width). On a DTensor that autograd records, the
    backward pass splits the gradient with :func:`split_dim`."""
    dim = dim % t.dim()
    if is_dtensor(t) and t.requires_grad:
        return _Merge.apply(t, dim)
    return t.reshape(*t.shape[:dim], -1, *t.shape[dim + 2:])


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    from .tuning import get_tuning

    if get_tuning().norm_bf16_io and x.dtype == torch.bfloat16:
        # keep the (B, S, D) stream in bf16; f32 only inside the reduction
        var = x.float().square().mean(dim=-1, keepdim=True)
        scale = torch.rsqrt(var + eps).to(x.dtype)
        return x * scale * (1.0 + gamma.float()).to(x.dtype)
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(dt)


def rotary_embedding(positions: torch.Tensor, dim: int,
                     theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions; shapes (..., dim//2)."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2).

    As in the reference, a bf16 ``x`` times the f32 tables is computed in
    f32 (both operands are tensors, so torch promotes as JAX does) and
    cast back once at the end."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def activation_fn(name: str):
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], f32, on the generator's device
    (std 0.8796, as ``jax.random.truncated_normal(key, -2, 2)``; the draws
    are Philox, not threefry, so they are not the reference's numbers)."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, shape, dtype,
               in_axis: int = 0) -> torch.Tensor:
    fan_in = shape[in_axis]
    std = 1.0 / math.sqrt(fan_in)
    return (_truncated_normal(shape, generator) * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return _truncated_normal(shape, generator).to(dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy; logits (..., V), labels (...).

    The gold logit is a one-hot reduction, as in the reference (which keeps
    it so for a vocab sharded over a mesh axis)."""
    v = logits.shape[-1]
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = (logits - m).float()
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    onehot = (labels[..., None] == torch.arange(v, device=labels.device)).float()
    gold = (shifted * onehot).sum(dim=-1)
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
