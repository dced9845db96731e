"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(routed)=1536
vocab=102400 — MLA with kv_lora_rank=512 / q_lora_rank=1536 /
rope_head_dim=64; 2 shared + 160 routed experts, top-6; first layer dense
(d_ff=12288) [arXiv:2405.04434; hf].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,               # dense first layer
    moe_d_ff=1536,            # routed/shared expert hidden
    vocab_size=102400,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    first_dense_layers=1,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    act="swiglu",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=8,
    head_dim=8,
    d_ff=160,
    moe_d_ff=32,
    vocab_size=512,
    n_experts=8,
    n_shared_experts=2,
    moe_top_k=2,
    first_dense_layers=1,
    kv_lora_rank=16,
    q_lora_rank=24,
    rope_head_dim=8,
    act="swiglu",
    tie_embeddings=False,
    dtype="float32",
)
