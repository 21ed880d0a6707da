"""Qwen1.5 32B — dense decoder with QKV bias, GQA kv=40 (MHA-like).
[hf:Qwen/Qwen1.5-0.5B; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    mlp="swiglu",
)
