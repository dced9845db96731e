"""Hand-written Hopper kernels of the port, each beside its plain version.

No kernel has a backward pass: a wrapper writes its result into a fresh
tensor, which autograd cannot see through. So each wrapper refuses, on
the card, a call that autograd would want a gradient from
(:func:`refuse_grad`), rather than return a result that silently drops
it. The plain versions run under autograd.
"""

import torch

__all__ = ["needs_grad", "refuse_grad"]


def needs_grad(*tensors) -> bool:
    """Whether autograd would carry a gradient through a call on
    ``tensors``: grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when :func:`needs_grad` holds for a call of
    kernel ``name``."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass and an input "
            "requires grad, so its result would carry no gradient; run the "
            "plain path (impl=\"ref\" in the model, which autograd "
            "differentiates), or call under torch.no_grad()")
