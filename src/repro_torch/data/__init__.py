"""The deterministic synthetic data pipeline (a copy of the JAX package's
``repro.data``)."""

from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]
