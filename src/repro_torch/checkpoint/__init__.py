"""Checkpointing (the port of the JAX package's ``repro.checkpoint``)."""

from .store import CheckpointConfig, CheckpointStore

__all__ = ["CheckpointConfig", "CheckpointStore"]
