"""Architecture registry: the 10 assigned configs, a copy of the JAX
package's ``repro.configs`` with the port's :class:`ModelConfig` (each
record value for value the reference's), and the paper's own suite
(:mod:`repro_torch.configs.paper`, ``PaperSuite``).

``get_config(arch)`` / ``get_smoke(arch)`` resolve by id; ``ARCHS`` lists
all ids. Shapes live in :mod:`repro_torch.configs.shapes`.
"""

from __future__ import annotations

import importlib

from .shapes import SHAPES, ShapeSpec, applicable_shapes

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "gemma3-27b": "gemma3_27b",
    "gemma-2b": "gemma_2b",
    "gemma2-2b": "gemma2_2b",
    "granite-20b": "granite_20b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "pixtral-12b": "pixtral_12b",
    "mamba2-1.3b": "mamba2_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE


__all__ = ["ARCHS", "get_config", "get_smoke", "SHAPES", "ShapeSpec",
           "applicable_shapes"]
