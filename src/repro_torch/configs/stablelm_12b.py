"""StableLM-2 12B — dense decoder, LayerNorm, GQA kv=8.
[hf:stabilityai/stablelm-2-1_6b; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    norm="layernorm",
    mlp="swiglu",
)
