"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-style code model, head_dim=128 [arXiv:2405.04324; hf].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    glu=False,            # gpt_bigcode-style plain MLP
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=1,
    d_ff=192,
    vocab_size=512,
    act="gelu",
    glu=False,
    dtype="float32",
)
