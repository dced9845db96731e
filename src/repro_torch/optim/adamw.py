"""AdamW with f32 moments, global-norm clipping and LR schedules.

The port of the JAX package's ``repro.optim.adamw``, as plain functions
over tensors. It is not ``torch.optim.AdamW``, which keeps the moments in
the parameter's type, has no global-norm clip and no per-step schedule,
and rounds its decoupled decay differently. Parameters, gradients and the
moments are dicts from a parameter's name to its tensor
(``dict(model.named_parameters())``; a module is read so). The reference
updates a pytree functionally; :func:`adamw_update` updates the
parameters and the moments in place, one leaf at a time, so that only one
leaf's f32 temporaries are live at once. Each update follows the
reference's float32 arithmetic operation by operation and casts the
parameter back to its type. Weight decay applies to every leaf, norms and
embeddings included, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["OptimizerConfig", "init_opt_state", "adamw_update", "lr_at_step",
           "global_norm"]


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"    # cosine | linear | constant


def lr_at_step(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor): a
    float32 scalar, computed in float32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1.0, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> dict:
    """Zero f32 moments ``m`` and ``v`` per parameter (a module or a dict
    of tensors), and ``count``, an int32 scalar at 0, on the parameters'
    device."""
    named = _named(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(named.values())).device if named else "cpu"
    return {"m": {n: zeros(p) for n, p in named.items()},
            "v": {n: zeros(p) for n, p in named.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every tensor of ``tree``, in float32."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in tree.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(params, grads: dict, opt_state: dict, cfg: OptimizerConfig):
    """One AdamW step, in place. ``params`` (a module or a dict of
    tensors) and ``opt_state``'s moments are updated; ``count`` is replaced
    by ``count + 1``. ``grads`` maps each parameter's name to its gradient.
    Returns ``(params, opt_state, {"grad_norm", "lr"})``."""
    named = _named(params)
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip:
        # ``clip / t`` on a tensor multiplies by its reciprocal: divide a
        # full tensor, as the reference does
        scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9),
                            max=1.0)
    lr = lr_at_step(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    for name, p in named.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32, copy=True)
        if scale is not None:
            g.mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        den = (v / c2).sqrt_().add_(cfg.eps)
        step = (m / c1).div_(den)
        del den
        p32 = p.float()                    # p itself when p is float32
        if cfg.weight_decay:
            step.add_(cfg.weight_decay * p32)
        step.mul_(lr)
        if p32 is p:
            p.sub_(step)
        else:
            p.copy_(p32.sub_(step))
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
