"""Unified language-model definition covering all assigned architectures.

The port of the JAX package's ``repro.models.lm``. A model is a sequence
of homogeneous **segments**; each segment is a ``ModuleList`` of
identical :class:`Block` modules, run in a Python loop where the reference
stacks the layers under ``lax.scan``. Segment kinds:

  * ``dense``   — attention + GLU FFN (gemma/granite/pixtral/llama family),
                  with optional local/global window alternation via per-layer
                  flags (gemma-2: 1:1, gemma-3: 5:1) and logit soft-capping;
  * ``moe``     — attention (GQA or MLA) + mixture-of-experts FFN
                  (mixtral, deepseek-v2 incl. shared experts);
  * ``ssm``     — Mamba-2 SSD blocks (mamba2);
  * ``hybrid_super`` — ``inner`` Mamba-2 layers followed by one
                  application of a single *shared* attention (+FFN) block
                  (zamba2): the shared block's weights live outside the
                  segments and its KV cache is allocated per *application*;
  * an encoder of bidirectional dense blocks (seamless), and
    **cross-attention** in a dense decoder (seamless).

The entry points are functions on an :class:`LM` module: ``init_params``
(draws an ``LM`` on ``device``, the card unless the caller asks for the
CPU), ``forward``, ``encode``, ``loss_fn``, ``init_cache``,
``decode_step`` and ``prefill``. Every attention call takes ``impl``
(:data:`repro_torch.models.attention.IMPLS`): on the card ``"auto"`` runs
the flash kernels and ``"ref"`` the plain path. The decode cache is
updated in place; its position is a Python int.

Weights are built with ``requires_grad=False`` (serving needs no
gradient); the train state turns them on
(:func:`repro_torch.launch.init_train_state`). The flash kernels have no
backward pass, so a gradient wants ``impl="ref"``: the plain attention
under autograd, as the reference's ``loss_fn`` runs off a TPU. With
``remat`` (the default) each block runs under
``torch.utils.checkpoint`` when autograd records, the counterpart of the
reference's ``jax.checkpoint`` of each layer: the backward pass recomputes
a block's activations from its input instead of keeping them. The chunked
loss (``ce_chunk``) checkpoints each chunk's head and cross entropy, as
the reference's ``chunk_loss`` is.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, MLA, init_attn_params, init_mla_params
from .common import ModelConfig, cross_entropy_loss, embed_init, is_dtensor, rms_norm
from .ffn import FFN, MoE, ffn_block, init_ffn_params, init_moe_params, moe_block
from .ssm import SSM, init_ssm_cache, init_ssm_params, ssm_decode_step

__all__ = [
    "SegmentSpec", "segment_plan", "n_attn_apps", "Block", "LM",
    "init_params", "forward", "encode", "init_cache", "prefill",
    "decode_step", "loss_fn", "num_params", "replicated_tables",
]


# ---------------------------------------------------------------------------
# Segment planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SegmentSpec:
    kind: str                  # dense | moe | ssm | hybrid_super
    count: int
    d_ff: int = 0              # dense FFN width override (deepseek layer 0)
    global_flags: tuple = ()   # per-layer: full-attention layer?
    attn_flags: tuple = ()     # hybrid: apply shared attention after layer i?
    cross: bool = False        # decoder cross-attention
    inner: int = 0             # hybrid_super: ssm layers per shared-attn app


def _flags(flags) -> tuple:
    return tuple(bool(f) for f in flags)


def segment_plan(cfg: ModelConfig) -> list[SegmentSpec]:
    if cfg.family in ("dense", "vlm"):
        return [SegmentSpec("dense", cfg.n_layers,
                            global_flags=_flags(cfg.global_flags()),
                            cross=cfg.cross_attention)]
    if cfg.family == "audio":  # encoder-decoder
        return [SegmentSpec("dense", cfg.n_layers,
                            global_flags=_flags(cfg.global_flags()),
                            cross=True)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append(SegmentSpec("dense", cfg.first_dense_layers,
                                    d_ff=cfg.d_ff,
                                    global_flags=(True,) * cfg.first_dense_layers))
        n_moe = cfg.n_layers - cfg.first_dense_layers
        segs.append(SegmentSpec("moe", n_moe,
                                global_flags=_flags(cfg.global_flags()[cfg.first_dense_layers:])))
        return segs
    if cfg.family == "ssm":
        return [SegmentSpec("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        k = max(1, cfg.attn_every)
        n_super, tail = divmod(cfg.n_layers, k)
        segs = [SegmentSpec("hybrid_super", n_super, inner=k)]
        if tail:
            segs.append(SegmentSpec("ssm", tail))
        return segs
    raise ValueError(f"unknown family {cfg.family}")


def n_attn_apps(cfg: ModelConfig) -> int:
    """Number of shared-attention applications in a hybrid stack."""
    return sum(s.count for s in segment_plan(cfg) if s.kind == "hybrid_super")


def _layer_flags(spec: SegmentSpec) -> tuple:
    return spec.global_flags or (True,) * spec.count


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cfg.d_model, dtype=cfg.torch_dtype,
                                    device=device), requires_grad=False)


def _sub(cfg, generator, device, init, cls, **kw):
    """A sub-module: drawn by ``init`` when there is a generator, else
    allocated by ``cls`` (to be filled, as by ``params_from_reference``)."""
    if generator is None:
        return cls(cfg, device=device, **kw)
    return init(cfg, generator, device=device, **kw)


class InnerSSM(nn.Module):
    """One Mamba-2 layer of a ``hybrid_super`` block: ``norm1``, ``ssm``."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.norm1 = _norm(cfg, device)
        self.ssm = _sub(cfg, generator, device, init_ssm_params, SSM)


class Block(nn.Module):
    """One layer of a segment of kind ``spec.kind``, with the reference's
    parameter names: ``dense``/``moe``: ``norm1``, ``attn`` (GQA or MLA),
    ``cross`` and ``norm_cross`` (decoder cross-attention), ``norm2``,
    ``ffn`` or ``moe``; ``ssm``: ``norm1``, ``ssm``; ``hybrid_super``:
    ``inner`` (a ``ModuleList`` of :class:`InnerSSM`), ``norm2``, ``norm3``
    (the shared block's norms). :meth:`forward` is the reference's
    ``_block_train``, :meth:`decode` its ``_block_decode``."""

    def __init__(self, cfg: ModelConfig, spec: SegmentSpec, device="cuda",
                 generator=None):
        super().__init__()
        self.cfg, self.kind, self.cross_attn = cfg, spec.kind, spec.cross
        if spec.kind in ("dense", "moe"):
            self.norm1, self.norm2 = _norm(cfg, device), _norm(cfg, device)
            if cfg.kv_lora_rank:
                self.attn = _sub(cfg, generator, device, init_mla_params, MLA)
            else:
                self.attn = _sub(cfg, generator, device, init_attn_params, Attention)
            if spec.cross:
                self.cross = _sub(cfg, generator, device, init_attn_params, Attention)
                self.norm_cross = _norm(cfg, device)
            if spec.kind == "dense":
                self.ffn = _sub(cfg, generator, device, init_ffn_params, FFN,
                                d_ff=spec.d_ff or cfg.d_ff)
            else:
                self.moe = _sub(cfg, generator, device, init_moe_params, MoE)
        elif spec.kind == "ssm":
            self.norm1 = _norm(cfg, device)
            self.ssm = _sub(cfg, generator, device, init_ssm_params, SSM)
        elif spec.kind == "hybrid_super":
            self.inner = nn.ModuleList(InnerSSM(cfg, device, generator)
                                       for _ in range(spec.inner))
            self.norm2, self.norm3 = _norm(cfg, device), _norm(cfg, device)
        else:
            raise ValueError(spec.kind)

    def _attend_rest(self, x, memory, impl):
        """Cross-attention and the FFN / MoE of a dense or moe layer."""
        cfg = self.cfg
        aux = 0.0
        if self.cross_attn and memory is not None:
            x = x + self.cross(rms_norm(x, self.norm_cross), kv=memory, impl=impl)
        h = rms_norm(x, self.norm2)
        if self.kind == "dense":
            x = x + ffn_block(cfg, self.ffn, h)
        else:
            out, aux = moe_block(cfg, self.moe, h)
            x = x + out
        return x, aux

    def _shared(self, x, a, shared):
        """The rest of a hybrid_super layer after the shared attention."""
        x = x + a
        if shared[1] is not None:
            x = x + ffn_block(self.cfg, shared[1], rms_norm(x, self.norm3))
        return x

    def forward(self, x, flag: bool = True, memory=None, shared=None,
                impl: str = "auto"):
        """One block on a sequence; returns (x, aux). ``shared`` is the
        hybrid's (shared attention, shared FFN or None)."""
        if self.kind in ("dense", "moe"):
            h = rms_norm(x, self.norm1)
            if self.cfg.kv_lora_rank:
                x = x + self.attn(h, impl=impl)
            else:
                x = x + self.attn(h, is_global=flag, impl=impl)
            return self._attend_rest(x, memory, impl)
        if self.kind == "ssm":
            return x + self.ssm(rms_norm(x, self.norm1)), 0.0
        for layer in self.inner:
            x = x + layer.ssm(rms_norm(x, layer.norm1))
        a = shared[0](rms_norm(x, self.norm2), impl=impl)
        return self._shared(x, a, shared), 0.0

    def decode(self, x, cache_l: dict, flag: bool, pos: int, memory=None,
               shared=None, impl: str = "auto"):
        """One block of the decode step; updates this layer's cache views
        ``cache_l`` in place and returns x."""
        if self.kind in ("dense", "moe"):
            h = rms_norm(x, self.norm1)
            if self.cfg.kv_lora_rank:
                a, _, _ = self.attn.decode(h, cache_l["ckv"], cache_l["krope"],
                                           pos, impl=impl)
            else:
                a, _, _ = self.attn.decode(h, cache_l["k"], cache_l["v"], pos,
                                           is_global=flag, impl=impl)
            return self._attend_rest(x + a, memory, impl)[0]
        if self.kind == "ssm":
            out, _ = ssm_decode_step(self.cfg, self.ssm, rms_norm(x, self.norm1),
                                     cache_l)
            return x + out
        for j, layer in enumerate(self.inner):
            out, _ = ssm_decode_step(self.cfg, layer.ssm, rms_norm(x, layer.norm1),
                                     _index(cache_l["inner"], j))
            x = x + out
        a, _, _ = shared[0].decode(rms_norm(x, self.norm2), cache_l["attn_k"],
                                   cache_l["attn_v"], pos, impl=impl)
        return self._shared(x, a, shared)


class Encoder(nn.Module):
    """The encoder stack: ``segment`` (dense blocks) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        spec = SegmentSpec("dense", cfg.n_encoder_layers,
                           global_flags=(True,) * cfg.n_encoder_layers)
        self.segment = nn.ModuleList(Block(cfg, spec, device, generator)
                                     for _ in range(spec.count))
        self.final_norm = _norm(cfg, device)


class LM(nn.Module):
    """The model: ``embed`` (V, D), ``final_norm``, ``unembed`` (untied
    embeddings), ``segments`` (a ``ModuleList`` per :func:`segment_plan`
    entry, each a ``ModuleList`` of :class:`Block`), ``shared_attn`` and
    ``shared_ffn`` (hybrid), ``encoder`` (encoder-decoder). Weights are
    drawn from ``generator`` when one is given, else left to be filled."""

    def __init__(self, cfg: ModelConfig, device="cuda", generator=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype

        def table():
            w = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt, device=device)
            if generator is not None:
                w.copy_(embed_init(generator, tuple(w.shape), dt))
            return nn.Parameter(w, requires_grad=False)

        self.embed = table()
        self.final_norm = _norm(cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = table()
        self.segments = nn.ModuleList(
            nn.ModuleList(Block(cfg, spec, device, generator) for _ in range(spec.count))
            for spec in segment_plan(cfg))
        if cfg.family == "hybrid":
            # Zamba2's single shared transformer block (attention + FFN),
            # reused at every flagged layer.
            self.shared_attn = _sub(cfg, generator, device, init_attn_params, Attention)
            if cfg.d_ff:
                self.shared_ffn = _sub(cfg, generator, device, init_ffn_params, FFN,
                                       d_ff=cfg.d_ff)
        if cfg.n_encoder_layers:
            self.encoder = Encoder(cfg, device, generator)

    def shared(self):
        """(shared attention, shared FFN or None) of a hybrid, else None."""
        if not hasattr(self, "shared_attn"):
            return None
        return self.shared_attn, getattr(self, "shared_ffn", None)

    def forward(self, tokens, **kw):
        return forward(self.cfg, self, tokens, **kw)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                device="cuda", seed: int = 0) -> LM:
    """An :class:`LM` on ``device`` with weights drawn from ``generator``
    (default: a generator on ``device`` seeded with ``seed``): truncated
    normals in [-2, 2] scaled by 1/sqrt(fan_in) for matrices, unscaled for
    embeddings, zero norm gains, as in the reference (the draws are Philox,
    so not the reference's numbers). Wants the card unless ``device`` says
    otherwise, and raises without one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: device 'cuda' asked for and no CUDA "
                           "device is available; pass device='cpu' to run on "
                           "the CPU")
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    elif generator.device.type != device.type:
        raise ValueError(f"init_params: the generator is on {generator.device}, "
                         f"the weights on {device}")
    return LM(cfg, device, generator)


def num_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


#: how many :func:`replicated_tables` scopes over DTensor weights are open
_replication_depth = 0


@contextlib.contextmanager
def replicated_tables(model: LM):
    """The scope a step runs in: on a model whose weights are DTensors,
    ``implicit_replication()``, else nothing. A step builds plain tensors
    (rotary tables, masks, positions, the zero aux loss) that are the same
    on every rank; taken as replicated against the DTensor weights they
    are exact, and building each as a DTensor would thread the mesh
    through every function of the model. A train step's backward pass
    runs in it too: autograd meets the saved tables there. Nested, only
    the outermost scope enters ``implicit_replication``, which turns the
    switch off on exit, not back to what it was."""
    global _replication_depth
    if not is_dtensor(model.embed):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    outermost = _replication_depth == 0
    _replication_depth += 1
    try:
        with implicit_replication() if outermost else contextlib.nullcontext():
            yield
    finally:
        _replication_depth -= 1


def _with_replicated_tables(fn):
    """``fn(cfg, model, ...)`` run inside ``replicated_tables(model)``."""

    @functools.wraps(fn)
    def wrapped(cfg, model, *args, **kw):
        with replicated_tables(model):
            return fn(cfg, model, *args, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _embed_tokens(cfg: ModelConfig, model: LM, tokens):
    if is_dtensor(model.embed):
        # The lookup of a vocab-sharded table is a masked gather and a sum
        # over the vocab shards in XLA. DTensor's forms of it lack a
        # backward in torch 2.11 (indexing's ``index_put``; the masked
        # partial sum of ``F.embedding``), so the table's vocab dim is
        # gathered for the lookup: an all-gather the dry run counts. The
        # same rows as indexing.
        from torch.distributed.tensor import Replicate

        table = model.embed
        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
        x = F.embedding(tokens, table)
    else:
        x = model.embed[tokens]
    if cfg.embed_scale:
        # sqrt(d_model) rounded to x's type first, as the reference casts it
        # (a product of two values of that type rounds once, whichever
        # framework multiplies)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


@_with_replicated_tables
def encode(cfg: ModelConfig, model: LM, frontend_embeds, remat: bool = True,
           impl: str = "auto"):
    """Encoder stack over precomputed frontend embeddings (audio stub)."""
    x = frontend_embeds.to(cfg.torch_dtype)
    for blk in model.encoder.segment:
        x = _remat(remat, _encoder_layer, cfg, blk, x, impl)
    return rms_norm(x, model.encoder.final_norm)


def _encoder_layer(cfg: ModelConfig, blk: Block, x, impl: str):
    x = x + blk.attn(rms_norm(x, blk.norm1), causal=False, impl=impl)
    return x + ffn_block(cfg, blk.ffn, rms_norm(x, blk.norm2))


def _remat(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` is
    set and autograd records (without a graph there is nothing to
    recompute)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _backbone(cfg: ModelConfig, model: LM, tokens, *, embeds=None, memory=None,
              remat: bool = True, impl: str = "auto"):
    """Embed -> segments -> final norm; returns (x_text, aux_loss)."""
    x = _embed_tokens(cfg, model, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = model.shared()
    for spec, seg in zip(segment_plan(cfg), model.segments):
        aux_seg = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk, flag in zip(seg, _layer_flags(spec)):
            x, aux = _remat(remat, blk, x, flag, memory, shared, impl)
            aux_seg = aux_seg + aux
        aux_total = aux_total + aux_seg
    x = rms_norm(x, model.final_norm)
    if embeds is not None:
        x = x[:, embeds.shape[1]:]  # only text positions produce logits
    return x, aux_total


def _head(cfg: ModelConfig, model: LM, x):
    unembed = model.unembed if hasattr(model, "unembed") else model.embed
    logits = x @ unembed.T.to(x.dtype)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


@_with_replicated_tables
def forward(cfg: ModelConfig, model: LM, tokens, *, embeds=None, memory=None,
            remat: bool = True, impl: str = "auto"):
    """Full-sequence forward. Returns (logits, aux_loss).

    ``embeds``: precomputed modality embeddings prepended to the token
    embeddings (VLM patch embeddings). ``memory``: encoder output for
    cross-attention (audio/enc-dec).
    """
    x, aux_total = _backbone(cfg, model, tokens, embeds=embeds, memory=memory,
                             remat=remat, impl=impl)
    return _head(cfg, model, x), aux_total


@_with_replicated_tables
def loss_fn(cfg: ModelConfig, model: LM, batch, remat: bool = True,
            impl: str = "auto"):
    """``ce + 0.01 * aux`` and ``{"ce", "aux"}``. With the ``ce_chunk``
    knob the head runs over sequence chunks, each checkpointed when
    autograd records, so the full (B, S, V) logits never exist at once,
    in the forward pass or the backward."""
    from .tuning import get_tuning

    return _loss(cfg, model, batch, remat, impl, get_tuning().ce_chunk)


def _loss(cfg: ModelConfig, model: LM, batch, remat: bool, impl: str, nchunk: int):
    s = batch["tokens"].shape[1]
    if nchunk and s % nchunk == 0 and batch.get("mask") is None:
        x, aux = _backbone(cfg, model, batch["tokens"], embeds=batch.get("embeds"),
                           memory=batch.get("memory"), remat=remat, impl=impl)
        b = x.shape[0]
        c = s // nchunk
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, c):
            total = total + _remat(True, _chunk_loss, cfg, model, x[:, i:i + c],
                                   batch["labels"][:, i:i + c])
        ce = total / (b * s)
    else:
        logits, aux = forward(cfg, model, batch["tokens"], embeds=batch.get("embeds"),
                              memory=batch.get("memory"), remat=remat, impl=impl)
        ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _chunk_loss(cfg: ModelConfig, model: LM, xc, lc):
    """One chunk's summed cross entropy (its mean times its token count)."""
    return cross_entropy_loss(_head(cfg, model, xc), lc) * lc.numel()


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------

def _attn_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.kv_lora_rank:
        return {
            "ckv": (batch, max_len, cfg.kv_lora_rank),
            "krope": (batch, max_len, cfg.rope_head_dim),
        }
    return {
        "k": (batch, max_len, cfg.n_kv_heads, cfg.hd),
        "v": (batch, max_len, cfg.n_kv_heads, cfg.hd),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> dict:
    """Allocate the decode cache (zeros), in the reference's layout: per
    segment a dict of tensors with a leading layer axis, and ``pos``, a
    Python int.

    Hybrid models allocate the shared-attention KV cache per *application*
    (``n_attn_apps``), not per layer — 6x smaller for zamba2.
    """
    dtype = dtype or cfg.torch_dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = []
    for spec in segment_plan(cfg):
        if spec.kind in ("dense", "moe"):
            caches.append({k: zeros(spec.count, *s) for k, s in
                           _attn_cache_shapes(cfg, batch, max_len).items()})
        elif spec.kind == "ssm":
            c = init_ssm_cache(cfg, batch, dtype, device="meta")
            caches.append({k: zeros(spec.count, *a.shape) for k, a in c.items()})
        elif spec.kind == "hybrid_super":
            # inner ssm caches stacked (count, inner, ...); one shared-attn
            # KV cache slot per super-block application.
            c = init_ssm_cache(cfg, batch, dtype, device="meta")
            caches.append({
                "inner": {k: zeros(spec.count, spec.inner, *a.shape) for k, a in c.items()},
                "attn_k": zeros(spec.count, batch, max_len, cfg.n_kv_heads, cfg.hd),
                "attn_v": zeros(spec.count, batch, max_len, cfg.n_kv_heads, cfg.hd),
            })
    return {"segments": caches, "pos": 0}


def _index(tree: dict, i: int) -> dict:
    """Layer ``i``'s views of a cache dict with a leading layer axis."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


@torch.no_grad()
@_with_replicated_tables
def decode_step(cfg: ModelConfig, model: LM, cache: dict, tokens, *,
                memory=None, impl: str = "auto"):
    """One-token decode. tokens: (B, 1). Returns (logits, cache): the cache
    is updated in place, ``pos`` advanced by one."""
    pos = cache["pos"]
    x = _embed_tokens(cfg, model, tokens)
    shared = model.shared()
    for spec, seg, seg_cache in zip(segment_plan(cfg), model.segments, cache["segments"]):
        for i, (blk, flag) in enumerate(zip(seg, _layer_flags(spec))):
            x = blk.decode(x, _index(seg_cache, i), flag, pos, memory, shared, impl)
    x = rms_norm(x, model.final_norm)
    cache["pos"] = pos + 1
    return _head(cfg, model, x), cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: LM, tokens, *, embeds=None, memory=None,
            max_len: int | None = None, impl: str = "auto"):
    """Run the prompt through the model, producing a primed cache.

    As in the reference, a single-token :func:`decode_step` for each prompt
    token: exactly consistent with the decode path. ``embeds`` is accepted
    and, as in the reference, not consumed. Returns (logits (B, S, V),
    cache).
    """
    b, s = tokens.shape
    max_len = max_len or (s + 64)
    cache = init_cache(cfg, b, max_len, device=model.embed.device)
    logits = []
    for i in range(s):
        lg, cache = decode_step(cfg, model, cache, tokens[:, i:i + 1],
                                memory=memory, impl=impl)
        logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), cache
