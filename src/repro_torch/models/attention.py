"""Attention blocks: GQA/MQA, sliding-window + global patterns, soft-capping,
RoPE, MLA (DeepSeek-V2 latent attention), and KV-cache decode paths.

The port of the JAX package's ``repro.models.attention``. The inner
attention product routes through :func:`attention_op`: on CUDA tensors it
launches the port's hand-written Hopper flash kernels
(:func:`repro_torch.kernels.ops.flash_attention`), on CPU tensors it runs
:func:`attention_reference`, the reference's own path off a TPU. There is
no silent fallback: a kernel that fails to build or launch, a layout it
does not take or a head dim above 256 raises (a head dim between the built
ones, such as zamba2-7b's 112 or deepseek-v2's MLA 192, runs zero-padded
to the next, exactly), and so does a CUDA call that autograd would want a
gradient from, since the kernels have no backward pass: training runs
``impl="ref"``.

On DTensors (weights placed by :mod:`repro_torch.parallel`) both routes
run on each rank's local shards through ``local_map``
(:func:`_on_local_shards`).

``window``, ``q_offset`` and ``kv_len`` are Python ints: a layer's
local/global choice is made on the host (where the reference selects it
under trace), and the decode position is an int in the cache, so no
kernel waits for a device read.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .common import (ModelConfig, apply_rope, dense_init, is_dtensor, merge_dims, rms_norm,
                     rotary_embedding, softcap, split_dim)

__all__ = [
    "Attention",
    "MLA",
    "init_attn_params",
    "attention_op",
    "attention_reference",
    "attn_block",
    "attn_decode_step",
    "init_mla_params",
    "mla_block",
    "mla_decode_step",
    "IMPLS",
    "Q_CHUNK",
]

#: ``attention_op``'s routes: ``auto`` (the kernel on CUDA tensors, the
#: plain path on CPU tensors), ``cuda`` (the kernel; raises off the card),
#: ``ref`` (the plain path on any device, the card's comparator).
IMPLS = ("auto", "cuda", "ref")
GLOBAL_WINDOW = 2 ** 30     # the reference's window of a global layer


def _weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight, built without ``requires_grad``: serving
    wants no gradient, and the train state turns it on."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def _draw(module: nn.Module, generator: torch.Generator, dense: dict,
          zeros: tuple = ()) -> None:
    """Fill ``module``'s weights: ``dense`` maps a name to its ``in_axis``
    (:func:`dense_init`), ``zeros`` are norm gains."""
    for name, in_axis in dense.items():
        w = getattr(module, name)
        w.copy_(dense_init(generator, tuple(w.shape), w.dtype, in_axis=in_axis))
    for name in zeros:
        getattr(module, name).zero_()


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention weights (``wq``, ``wk``, ``wv``, ``wo``, each
    ``(in, out)``); :meth:`forward` is :func:`attn_block`, :meth:`decode`
    :func:`attn_decode_step`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        hd, d, dt = cfg.hd, cfg.d_model, cfg.torch_dtype
        self.wq = _weight((d, cfg.n_heads * hd), dt, device)
        self.wk = _weight((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = _weight((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = _weight((cfg.n_heads * hd, d), dt, device)

    def forward(self, x, **kw):
        return attn_block(self.cfg, self, x, **kw)

    def decode(self, x, cache_k, cache_v, pos: int, **kw):
        return attn_decode_step(self.cfg, self, x, cache_k, cache_v, pos, **kw)


def init_attn_params(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda") -> Attention:
    p = Attention(cfg, device)
    _draw(p, generator, dict(wq=0, wk=0, wv=0, wo=0))
    return p


class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention weights [arXiv:2405.04434]:
    the KV path compresses to a latent of ``kv_lora_rank`` (plus a shared
    rope key) and decompresses per head; the query path is low-rank
    (``w_dq``, ``w_uq``, ``q_norm``) when ``q_lora_rank`` is set, else
    ``wq``. :meth:`forward` is :func:`mla_block`, :meth:`decode`
    :func:`mla_decode_step`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, hd, r, rd = cfg.d_model, cfg.hd, cfg.kv_lora_rank, cfg.rope_head_dim
        qr, nh, dt = cfg.q_lora_rank or 0, cfg.n_heads, cfg.torch_dtype
        self.w_dkv = _weight((d, r + rd), dt, device)
        self.w_uk = _weight((r, nh * hd), dt, device)
        self.w_uv = _weight((r, nh * hd), dt, device)
        self.wo = _weight((nh * hd, d), dt, device)
        self.kv_norm = _weight((r,), dt, device)
        if qr:
            self.w_dq = _weight((d, qr), dt, device)
            self.w_uq = _weight((qr, nh * (hd + rd)), dt, device)
            self.q_norm = _weight((qr,), dt, device)
        else:
            self.wq = _weight((d, nh * (hd + rd)), dt, device)

    def forward(self, x, **kw):
        return mla_block(self.cfg, self, x, **kw)

    def decode(self, x, cache_ckv, cache_krope, pos: int, **kw):
        return mla_decode_step(self.cfg, self, x, cache_ckv, cache_krope, pos, **kw)


def init_mla_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cuda") -> MLA:
    p = MLA(cfg, device)
    q = dict(w_dq=0, w_uq=0) if cfg.q_lora_rank else dict(wq=0)
    _draw(p, generator, dict(w_dkv=0, w_uk=0, w_uv=0, wo=0, **q),
          zeros=("kv_norm", "q_norm") if cfg.q_lora_rank else ("kv_norm",))
    return p


# ---------------------------------------------------------------------------
# Core attention op
# ---------------------------------------------------------------------------

def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 logit_cap: float = 0.0, q_offset: int = 0,
                 kv_len: int | None = None, impl: str = "auto") -> torch.Tensor:
    """Grouped-query attention.

    q: (B, S, H, Dh); k/v: (B, T, Hkv, Dh). ``q_offset`` is the absolute
    position of q[0] (decode); ``kv_len`` masks a padded cache.
    ``impl`` (:data:`IMPLS`): ``auto`` launches the flash kernel on CUDA
    tensors and runs :func:`attention_reference` on CPU tensors; ``cuda``
    launches the kernel and raises on any other device; ``ref`` runs
    :func:`attention_reference` wherever the tensors are.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset,
              kv_len=kv_len)
    if is_dtensor(q):
        return _on_local_shards(q, k, v, impl, kw)
    if impl == "ref" or (impl == "auto" and q.device.type == "cpu"):
        return attention_reference(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"attention_op(impl={impl!r}): the flash kernel "
                         f"runs on CUDA tensors, got {q.device}")
    from ..kernels import ops as kops

    return kops.flash_attention(q, k, v, **kw)


def _on_local_shards(q, k, v, impl: str, kw: dict):
    """Attention of DTensor q, k and v on each rank's local shards, through
    ``local_map``: the flash kernel on the card, so that it never receives
    a DTensor (whose ``data_ptr`` is not a device pointer), and the plain
    path as well, which spares DTensor's sharding propagation over the
    5-d score einsums. Attention is independent per batch row and per
    head, and GQA groups stay whole when q's and the KV heads are split
    alike and evenly, so each mesh dim shards batch (dim 0) or heads
    (dim 2) of all three, as k and v are placed (the decode cache, the
    large operand, stays where it is) or else as q is, where the sizes
    divide; any other mesh dim is gathered, and each of its ranks
    computes its rows' whole attention (gemma2-2b's 4 KV heads over a
    16-wide ``model`` axis: the dry run's useful-FLOPs ratio shows it).
    The flash wrapper's launches during the local calls also count in
    ``flash_attention.launches_sharded``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, places, split = q.device_mesh, [], {0: 1, 2: 1}
    for i, (pq, pk, pv) in enumerate(zip(q.placements, k.placements, v.placements)):
        target = Replicate()
        for p in (pk if pk == pv else None, pq):
            if isinstance(p, Shard) and p.dim in split:
                n = split[p.dim] * mesh.size(i)
                if q.shape[p.dim] % n == 0 and k.shape[p.dim] % n == 0:
                    target, split[p.dim] = p, n
                    break
        places.append(target)
    q, k, v = (t.redistribute(mesh, places) for t in (q, k, v))
    from ..kernels import ops as kops

    flash = kops.flash_attention

    def local(ql, kl, vl):
        before = flash.launches
        out = attention_op(ql, kl, vl, impl=impl, **kw)
        flash.launches_sharded += flash.launches - before
        return out

    return local_map(local, out_placements=places, in_placements=(places,) * 3,
                     device_mesh=mesh)(q, k, v)


Q_CHUNK = 1024  # reference-path query blocking (memory control on long seqs)


def _attention_dense(q, k, v, *, causal, window, logit_cap, q_offset, kv_len):
    from .tuning import get_tuning

    tune = get_tuning()
    b, s, h, dh = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    qg = split_dim(q, 2, (hkv, g))
    scale = 1.0 / math.sqrt(dh)
    # the product is taken in q's type and then cast, as in the reference:
    # in bf16 the logits are rounded to bf16 before the soft-cap
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if logit_cap and logit_cap > 0:
        logits = softcap(logits, logit_cap)
    qpos = torch.arange(s, device=q.device) + q_offset   # absolute positions of queries
    kpos = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    if tune.attn_additive_mask:
        logits = logits + torch.where(mask, 0.0, -1e30)
    else:
        logits = torch.where(mask, logits, -1e30)
    if tune.attn_probs_bf16:
        m = logits.max(dim=-1, keepdim=True).values
        p16 = torch.exp((logits - m).to(torch.bfloat16).float()).to(torch.bfloat16)
        denom = p16.float().sum(dim=-1, keepdim=True)
        probs = (p16.float() / denom).to(q.dtype)
    else:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return merge_dims(out, 2)


def attention_reference(q, k, v, *, causal=True, window=None, logit_cap=0.0,
                        q_offset=0, kv_len=None) -> torch.Tensor:
    """Reference attention, blocked over query chunks of :data:`Q_CHUNK`
    for long sequences (the score tensor is O(chunk * T), not O(S * T)).
    Rows with no visible key get the mean of v (the reference masks with
    -1e30, not -inf); the model path never has such a row."""
    b, s, h, dh = q.shape
    if s <= Q_CHUNK or s % Q_CHUNK != 0:
        return _attention_dense(q, k, v, causal=causal, window=window,
                                logit_cap=logit_cap, q_offset=q_offset,
                                kv_len=kv_len)
    return torch.cat([
        _attention_dense(q[:, i:i + Q_CHUNK], k, v, causal=causal,
                         window=window, logit_cap=logit_cap,
                         q_offset=q_offset + i, kv_len=kv_len)
        for i in range(0, s, Q_CHUNK)], dim=1)


# ---------------------------------------------------------------------------
# Full blocks (project -> rope -> attend -> output)
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    hd = cfg.hd
    q = split_dim(x @ p.wq, -1, (cfg.n_heads, hd))
    k = split_dim(x @ p.wk, -1, (cfg.n_kv_heads, hd))
    v = split_dim(x @ p.wv, -1, (cfg.n_kv_heads, hd))
    return q, k, v


def _layer_window(cfg: ModelConfig, is_global: bool | None) -> int | None:
    """This layer's window: ``cfg.window`` for a local layer (or when no
    flag is given), the reference's 2**30 for a global one."""
    if cfg.window is None:
        return None
    if is_global is None:
        return cfg.window
    return GLOBAL_WINDOW if is_global else cfg.window


def attn_block(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
               is_global: bool | None = None, positions=None,
               kv: torch.Tensor | None = None, causal: bool = True,
               impl: str = "auto") -> torch.Tensor:
    """Self-attention (kv=None) or cross-attention (kv=encoder memory).

    ``is_global``: this layer's full vs sliding-window choice (the
    gemma-2/3 alternation), a Python bool.
    """
    b, s, d = x.shape
    hd = cfg.hd
    if kv is None:
        q, k, v = _project_qkv(cfg, p, x)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attention_op(q, k, v, causal=causal,
                           window=_layer_window(cfg, is_global),
                           logit_cap=cfg.attn_softcap, impl=impl)
    else:
        t = kv.shape[1]
        q = split_dim(x @ p.wq, -1, (cfg.n_heads, hd))
        k = split_dim(kv @ p.wk, -1, (cfg.n_kv_heads, hd))
        v = split_dim(kv @ p.wv, -1, (cfg.n_kv_heads, hd))
        out = attention_op(q, k, v, causal=False, logit_cap=cfg.attn_softcap,
                           impl=impl)
    return merge_dims(out, 2) @ p.wo


def attn_decode_step(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, is_global: bool | None = None, impl: str = "auto"):
    """One-token decode with an in-place KV cache update.

    x: (B, 1, D); cache_k/v: (B, T, Hkv, Dh), written at ``pos`` in place
    (the reference returns updated copies); pos: the current position.
    Returns (out (B,1,D), cache_k, cache_v).
    """
    b, s, d = x.shape
    hd = cfg.hd
    q, k, v = _project_qkv(cfg, p, x)
    positions = torch.full((b, 1), pos, device=x.device)
    cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k.narrow(1, pos, 1).copy_(k)
    cache_v.narrow(1, pos, 1).copy_(v)
    out = attention_op(q, cache_k, cache_v, causal=False,
                       window=_layer_window(cfg, is_global),
                       logit_cap=cfg.attn_softcap, q_offset=pos,
                       kv_len=pos + 1, impl=impl)
    out = merge_dims(out, 2) @ p.wo
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(cfg: ModelConfig, p: MLA, x: torch.Tensor):
    b, s, _ = x.shape
    nh, hd, rd = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    if cfg.q_lora_rank:
        cq = rms_norm(x @ p.w_dq, p.q_norm)
        q = split_dim(cq @ p.w_uq, -1, (nh, hd + rd))
    else:
        q = split_dim(x @ p.wq, -1, (nh, hd + rd))
    return q[..., :hd], q[..., hd:]


def mla_block(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions=None,
              impl: str = "auto") -> torch.Tensor:
    """Prefill/train path. The latent cache formulation is exercised in the
    decode path; here keys/values are decompressed in full (standard)."""
    b, s, d = x.shape
    nh, hd, r, rd = cfg.n_heads, cfg.hd, cfg.kv_lora_rank, cfg.rope_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x)
    dkv = x @ p.w_dkv                          # (b, s, r + rd)
    c_kv = rms_norm(dkv[..., :r], p.kv_norm)
    k_rope = dkv[..., r:].reshape(b, s, 1, rd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rotary_embedding(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    k_nope = split_dim(c_kv @ p.w_uk, -1, (nh, hd))
    v = split_dim(c_kv @ p.w_uv, -1, (nh, hd))
    # Concatenate nope|rope components; rope key shared across heads (MQA-like)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, nh, rd)], dim=-1)
    # pad v to q's feature dim for the shared attention op, then slice back
    vp = torch.cat([v, v.new_zeros((b, s, nh, rd))], dim=-1)
    out = attention_op(q, k, vp, causal=True, impl=impl)[..., :hd]
    return merge_dims(out, 2) @ p.wo


def mla_decode_step(cfg: ModelConfig, p: MLA, x: torch.Tensor,
                    cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
                    pos: int, impl: str = "auto"):
    """Latent-cache decode: the cache stores (c_kv, k_rope) only — the
    memory advantage of MLA — and is written at ``pos`` in place. Keys and
    values are decompressed against the cache."""
    b, s, d = x.shape
    nh, hd, r, rd = cfg.n_heads, cfg.hd, cfg.kv_lora_rank, cfg.rope_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x)
    dkv = x @ p.w_dkv
    c_kv = rms_norm(dkv[..., :r], p.kv_norm)         # (b, 1, r)
    k_rope = dkv[..., r:].reshape(b, 1, 1, rd)
    positions = torch.full((b, 1), pos, device=x.device)
    cos, sin = rotary_embedding(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    cache_ckv.narrow(1, pos, 1).copy_(c_kv)
    cache_krope.narrow(1, pos, 1).copy_(k_rope[:, :, 0])
    t = cache_ckv.shape[1]
    k_nope = split_dim(cache_ckv @ p.w_uk, -1, (nh, hd))
    v = split_dim(cache_ckv @ p.w_uv, -1, (nh, hd))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, cache_krope[:, :, None, :].expand(b, t, nh, rd)], dim=-1)
    vp = torch.cat([v, v.new_zeros((b, t, nh, rd))], dim=-1)
    out = attention_op(q, k, vp, causal=False, q_offset=pos, kv_len=pos + 1,
                       impl=impl)[..., :hd]
    out = merge_dims(out, 2) @ p.wo
    return out, cache_ckv, cache_krope
