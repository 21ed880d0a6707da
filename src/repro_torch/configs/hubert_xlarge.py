"""HuBERT X-Large — encoder-only audio transformer (wav2vec2-style
backbone; CNN feature extractor is a stub: input_specs provides frame
embeddings).  No decode step.  [arXiv:2106.07447; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    norm="layernorm",
    mlp="gelu",
    frontend="audio",
)
