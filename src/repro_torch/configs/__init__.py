"""Architectures: ``--arch <id>`` resolves here.

Every arch of the reference is registered, and the model builds,
forwards, decodes and trains each family: the token decoders (dense
GQA, MLA, MoE), Mamba1, the Mamba2 hybrid, the encoder-only model and
the embeds-fed frontends.  ``SHAPES`` holds the reference's input-shape
cells.
"""

from .base import (
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, ArchConfig,
    ShapeConfig, applicable_shapes, smoke_config,
)
from .deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .grok_1_314b import CONFIG as grok_1_314b
from .hubert_xlarge import CONFIG as hubert_xlarge
from .llava_next_34b import CONFIG as llava_next_34b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .qwen1_5_32b import CONFIG as qwen1_5_32b
from .qwen2_0_5b import CONFIG as qwen2_0_5b
from .stablelm_12b import CONFIG as stablelm_12b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        llava_next_34b,
        stablelm_12b,
        qwen1_5_32b,
        qwen2_0_5b,
        nemotron_4_340b,
        zamba2_7b,
        falcon_mamba_7b,
        grok_1_314b,
        deepseek_v2_lite_16b,
        hubert_xlarge,
    )
}

__all__ = ["ARCHS", "ArchConfig", "DECODE_32K", "LONG_500K", "PREFILL_32K",
           "SHAPES", "ShapeConfig", "TRAIN_4K", "applicable_shapes",
           "smoke_config"]
