"""Nemotron-4 340B — dense decoder, GQA kv=8, squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    mlp="squared_relu",
    optimizer_dtype="bfloat16",   # bf16 optimizer moments, as the reference
)
