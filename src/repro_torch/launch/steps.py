"""Step functions of the serving path: prefill and decode.

The port of ``make_prefill_step`` and ``make_decode_step`` from the JAX
package's ``repro.launch.steps``. ``make_train_step`` waits for the
optimizer's slice; ``input_specs`` and the ``abstract_*`` functions wait
for the sharding slice (on the meta device). The steps run under
``torch.no_grad()``: this slice has no backward pass.
"""

from __future__ import annotations

import torch

from ..models import ModelConfig, decode_step, forward

__all__ = ["make_prefill_step", "make_decode_step"]


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
