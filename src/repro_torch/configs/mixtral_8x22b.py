"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) expert d_ff=16384
vocab=32768 — 8 experts, top-2 routing, sliding-window attention
[arXiv:2401.04088; hf].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    moe_top_k=2,
    window=4096,
    global_every=-1,         # SWA on every layer
    act="swiglu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    moe_top_k=2,
    window=8,
    global_every=-1,
    act="swiglu",
    tie_embeddings=False,
    dtype="float32",
)
