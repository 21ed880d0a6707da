"""Falcon-Mamba 7B — pure Mamba1 SSM, attention-free (d_ff=0).
[arXiv:2410.05355; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm="mamba1",
    ssm_state=16,
)
