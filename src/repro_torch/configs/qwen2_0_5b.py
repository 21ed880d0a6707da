"""Qwen2 0.5B — small dense decoder, GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    mlp="swiglu",
)
