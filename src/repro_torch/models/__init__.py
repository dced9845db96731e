"""Model zoo: unified LM covering dense / MoE / SSM / hybrid / VLM / enc-dec.

The port of the JAX package's ``repro.models``: prefill and decode, and
the loss the train step (:mod:`repro_torch.launch`) differentiates."""

from .common import ModelConfig, cross_entropy_loss
from .lm import (
    LM,
    SegmentSpec,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
    num_params,
    prefill,
    segment_plan,
)

__all__ = [
    "ModelConfig", "cross_entropy_loss", "SegmentSpec", "segment_plan",
    "init_params", "forward", "encode", "init_cache", "prefill",
    "decode_step", "loss_fn", "num_params", "LM",
]
