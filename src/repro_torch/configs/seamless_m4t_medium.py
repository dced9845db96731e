"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].

The speech frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings (B, frames, d_model) consumed by the encoder.
"""

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    cross_attention=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    act="geglu",
    tie_embeddings=True,
    frontend="audio",
    frontend_tokens=1024,     # speech frames per utterance (stub)
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    cross_attention=True,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    act="geglu",
    frontend="audio",
    frontend_tokens=16,
    dtype="float32",
)
