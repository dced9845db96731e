"""Step functions: train, prefill and decode.

The port of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` from the JAX package's ``repro.launch.steps``.
``input_specs`` and the ``abstract_*`` functions wait for the sharding
slice (on the meta device).

A train state is ``{"params": model, "opt": opt_state}``
(:func:`init_train_state`), the reference's layout with the model in
place of the parameter pytree. The train step differentiates ``loss_fn``
with autograd and updates the weights and the moments in place; there is
no ``jit`` and nothing to donate. The serving steps run under
``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from ..models import LM, ModelConfig, decode_step, forward, loss_fn
from ..optim import OptimizerConfig, adamw_update, init_opt_state

__all__ = ["init_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step"]


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def init_train_state(model: LM) -> dict:
    """``{"params": model, "opt": init_opt_state(model)}``, with every
    weight of ``model`` turned trainable (``requires_grad``)."""
    model.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(model)}


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
        loss, metrics = loss_fn(cfg, model, batch, remat=remat, impl=impl)
        loss.backward()
        # a weight the loss does not reach has no .grad; JAX's is zero
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
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
