"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
— alternating local(4096-window)/global attention, attention- and
final-logit soft-capping, head_dim=256 [arXiv:2408.00118; hf].
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    global_every=2,          # local/global alternating
    attn_softcap=50.0,
    final_softcap=30.0,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window=8,
    global_every=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="geglu",
    embed_scale=True,
    dtype="float32",
)
