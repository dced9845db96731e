"""Assigned input shapes (same four for every LM-family architecture).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``. ``long_500k`` only applies to
sub-quadratic architectures (SSM / hybrid) — see DESIGN.md §4.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Families allowed to run the long-context decode shape.
_SUBQUADRATIC = ("ssm", "hybrid")


def applicable_shapes(cfg) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in _SUBQUADRATIC:
        out.append("long_500k")
    return out
