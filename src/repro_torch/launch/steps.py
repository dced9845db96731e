"""Step functions: train, prefill and decode.

The port of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` from the JAX package's ``repro.launch.steps``.
``input_specs`` and the ``abstract_*`` functions give a step's inputs
and state on the ``meta`` device (shapes and types, nothing allocated),
the counterparts of the reference's ``ShapeDtypeStruct`` stand-ins and
``jax.eval_shape``; the dry run places them on a mesh.

A train state is ``{"params": model, "opt": opt_state}``
(:func:`init_train_state`), the reference's layout with the model in
place of the parameter pytree. The train step differentiates ``loss_fn``
with autograd and updates the weights and the moments in place; there is
no ``jit`` and nothing to donate. The serving steps run under
``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from ..configs.shapes import ShapeSpec
from ..models import LM, ModelConfig, decode_step, forward, init_cache, loss_fn
from ..models.common import is_dtensor
from ..models.lm import replicated_tables
from ..optim import OptimizerConfig, adamw_update, init_opt_state

__all__ = ["init_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step", "input_specs", "abstract_params",
           "abstract_train_state", "abstract_cache"]


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def init_train_state(model: LM) -> dict:
    """``{"params": model, "opt": init_opt_state(model)}``, with every
    weight of ``model`` turned trainable (``requires_grad``)."""
    model.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(model)}


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient in ``p``'s layout. A weight the loss does not reach
    has no ``.grad``; JAX's is zero. A DTensor gradient may hold a pending
    sum over the data axes (``Partial``): it is reduced onto the weight's
    placements, as the reference's ``out_shardings`` make XLA do."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig | None = None,
                    remat: bool = True, impl: str = "ref"):
    """``train_step(state, batch) -> (state, metrics)``: the gradient of
    ``loss_fn`` by autograd, then one AdamW step, both in place. Metrics
    are ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``, device
    scalars. ``impl="ref"`` runs the plain attention, which autograd
    differentiates; the flash kernels have no backward pass, and on the
    card any other ``impl`` raises rather than drop a gradient."""
    opt = opt or OptimizerConfig()

    def train_step(state, batch):
        model = state["params"]
        model.zero_grad(set_to_none=True)
        with replicated_tables(model):
            loss, metrics = loss_fn(cfg, model, batch, remat=remat, impl=impl)
            loss.backward()
            grads = {n: _grad(p) for n, p in model.named_parameters()}
            _, state["opt"], opt_metrics = adamw_update(model, grads, state["opt"], opt)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, remat: bool = True, impl: str = "auto"):
    """Full-sequence forward (what a prefill costs); returns logits."""

    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _ = forward(cfg, model, batch["tokens"], embeds=batch.get("embeds"),
                            memory=batch.get("memory"), remat=remat, impl=impl)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, impl: str = "auto"):
    """One-token decode against a cache; returns (logits, cache), the cache
    updated in place."""

    def serve_step(model, cache, batch):
        return decode_step(cfg, model, cache, batch["tokens"],
                           memory=batch.get("memory"), impl=impl)

    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs (on ``meta``; nothing allocated)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The step's inputs for one (arch x shape) cell as ``meta`` tensors in
    the reference's shapes and types: int32 tokens (and labels for train),
    frontend embeddings or encoder memory in the model's type."""
    b, tok = shape.global_batch, torch.int32

    def meta(*dims, dtype=tok):
        return torch.empty(dims, dtype=dtype, device="meta")

    frontend = meta(b, cfg.frontend_tokens, cfg.d_model, dtype=cfg.torch_dtype)
    if shape.kind == "decode":   # one new token against a seq_len-deep cache
        specs = {"tokens": meta(b, 1)}
        if cfg.frontend == "audio":
            specs["memory"] = frontend
        return specs
    s = shape.seq_len
    specs = {"tokens": meta(b, s)}
    if shape.kind == "train":
        specs["labels"] = meta(b, s)
    if cfg.frontend == "vision":
        specs["embeds"] = frontend
    if cfg.frontend == "audio":
        specs["memory"] = frontend
    return specs


def abstract_params(cfg: ModelConfig) -> LM:
    """The model on ``meta``: every weight's shape and type, no data."""
    return LM(cfg, device="meta")


def abstract_train_state(cfg: ModelConfig) -> dict:
    """``{"params", "opt"}`` on ``meta`` (:func:`init_train_state`)."""
    return init_train_state(abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache on ``meta``."""
    return init_cache(cfg, batch, max_len, device="meta")
