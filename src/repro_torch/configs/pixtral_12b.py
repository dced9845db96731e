"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128 — Pixtral-ViT frontend (STUB: ``input_specs``
provides precomputed patch embeddings) on a Mistral-NeMo-style decoder
[hf:mistralai/Pixtral-12B-2409].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="swiglu",
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=256,      # patch embeddings per image (stub)
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    act="swiglu",
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=8,
    dtype="float32",
)
