"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, embeddings scaled by sqrt(d) [arXiv:2403.08295; hf].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    act="geglu",
    embed_scale=True,
    dtype="float32",
)
