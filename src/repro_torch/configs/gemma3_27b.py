"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global interleaving, 1024-token sliding window on
local layers, head_dim=128, GeGLU [hf:google/gemma-3-*; arXiv:2503.19786].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window=1024,
    global_every=6,          # 5 local : 1 global
    act="geglu",
    embed_scale=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=8,
    global_every=6,
    act="geglu",
    embed_scale=True,
    dtype="float32",
)
