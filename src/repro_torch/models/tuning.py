"""Performance-tuning knobs (the §Perf hillclimb registry), a copy of the
JAX package's ``repro.models.tuning``.

Global, mutable, *explicitly recorded* knobs — a run states the tuning
fingerprint (:func:`tuning_tag`) so baselines and optimized variants are
never mixed (the paper's factor discipline applied to ourselves).

Knobs (all default to the paper-faithful/baseline behavior):

  * ``moe_defer_combine_psum`` and ``moe_vmap_dispatch`` — in the
    reference they change only how GSPMD shards the MoE dispatch; the port
    has no mesh yet, so they give the same numbers. They are kept so that
    :func:`tuning_tag` records them.
  * ``ce_chunk`` — compute the cross-entropy over sequence chunks
    (``loss_fn``; bounds the f32 logit buffers: live set /= n_chunks).
  * ``attn_additive_mask`` — apply attention masks as an additive bias
    instead of a separate ``where`` pass (the plain attention path).
  * ``attn_probs_bf16`` — round the softmax numerator to bf16 before the
    normalisation (the plain attention path).
  * ``norm_bf16_io`` — ``rms_norm`` keeps a bf16 stream in bf16; only the
    variance reduction accumulates in f32.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict, replace

__all__ = ["Tuning", "get_tuning", "set_tuning", "reset_tuning", "tuning_tag"]


@dataclass
class Tuning:
    moe_defer_combine_psum: bool = False
    moe_vmap_dispatch: bool = False    # batched scatter/gather (GSPMD keeps
                                       # the batch dim sharded; avoids the
                                       # full-batch all-reduce fallback)
    ce_chunk: int = 0
    attn_additive_mask: bool = False
    attn_probs_bf16: bool = False
    norm_bf16_io: bool = False         # rms_norm keeps x in bf16; only the
                                       # variance reduction accumulates f32


_TUNING = Tuning()


def get_tuning() -> Tuning:
    return _TUNING


def set_tuning(**kw) -> Tuning:
    global _TUNING
    _TUNING = replace(_TUNING, **kw)
    return _TUNING


def reset_tuning() -> Tuning:
    global _TUNING
    _TUNING = Tuning()
    return _TUNING


def tuning_tag() -> str:
    d = asdict(_TUNING)
    on = [f"{k}={v}" for k, v in d.items() if v not in (False, 0)]
    return ",".join(on) if on else "baseline"
