"""Zamba2 7B — hybrid: Mamba2 backbone with one SHARED attention+MLP block
applied every 6 mamba blocks.  Sliding-window attention enables long_500k.
[arXiv:2411.15242; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm="mamba2",
    ssm_state=64,
    ssm_heads=32,
    attn_every=6,
    window=4096,
    mlp="swiglu",
)
