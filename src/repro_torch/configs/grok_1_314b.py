"""Grok-1 314B — MoE 8 experts top-2, GQA kv=8.
[hf:xai-org/grok-1; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    mlp="gelu",
    optimizer_dtype="bfloat16",   # bf16 optimizer moments, as the reference
)
