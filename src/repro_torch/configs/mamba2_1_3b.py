"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280
ssm_state=128 — SSD (state-space duality), expand=2, head_dim=64
[arXiv:2405.21060].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=32,              # unused (attention-free); kept for input_specs
    n_kv_heads=32,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    dtype="float32",
)
