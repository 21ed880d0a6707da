"""Shared cases of DeepSeek's multi-head latent attention (MLA) for the
tests of its decode step: one layer's attention at DeepSeek-V2-Lite's and
at DeepSeek-V3's published widths, the re-expanded attention run on the
absorbed step's arguments, and the bounds that hold the served MLA step
against the reference package.

The served decode step attends with absorbed weights (no bf16 K or V is
made), where the reference re-expands K and V from the latent: the two
round in other places.  Each is about as far from an f32 evaluation of
the model as the other (median per-position RMS of the logits at smoke
width: 0.0112 against the reference's 0.0108 over a prompt and 12 steps,
0.0102 against 0.0107 over 20 single steps), and so they lie further from
each other than two steps that round alike.  Readings of the absorbed
step against the reference, smoke width: the largest logit difference
0.0703 and RMS 0.0112 (the token decoders' bound is 0.0625 and 0.01);
its router logits 7.55 bf16 ulps from the forward's (4 for steps that
round alike), and one router near-tie (a top-2 margin of 2 ulps) that
chose another expert, 1.33 apart in the logits there.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

# held to 1.5 times the token decoders' largest difference and 1.25 times
# their RMS (readings 0.0703 and 0.0112)
MLA_ATOL, MLA_RMS = 0.09375, 0.0125
# the router logits' largest difference between the absorbed step and a
# step that re-expands, in bf16 ulps of their magnitude (reading 7.55)
MLA_ROUTER_ULPS = 10

# DeepSeek-V2-Lite (huggingface.co/deepseek-ai/DeepSeek-V2-Lite): 16
# heads, no query LoRA, the plain rotary embedding
V2_LITE_ATTN = ArchConfig(
    name="deepseek-v2-lite-attn", family="moe", n_layers=1, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=10944, vocab=102400,
    mla=True, kv_lora_rank=512, qk_rope_dim=64, v_head_dim=128)
# DeepSeek-V3 (huggingface.co/deepseek-ai/DeepSeek-V3): 128 heads, the
# query LoRA, YaRN
V3_ATTN = ArchConfig(
    name="deepseek-v3-attn", family="moe", n_layers=1, d_model=7168,
    n_heads=128, n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
    mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_rope_dim=64,
    v_head_dim=128, rope_factor=40.0, rope_original_max=4096,
    rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=1.0,
    rope_mscale_all_dim=1.0)
ATTN = {"deepseek-v2-lite": V2_LITE_ATTN, "deepseek-v3": V3_ATTN}


def cut(cfg: ArchConfig, d_model: int) -> ArchConfig:
    """``cfg`` at another model width; the attention's own widths kept."""
    return dataclasses.replace(cfg, d_model=d_model)


def reexpanded(q_nope, q_rope, c_kv, k_rope, p, scale, valid):
    """``layers._absorbed_attention``'s arguments through the re-expanded
    attention, the reference's order of operations: the one query
    attended as a prompt's are.  → (B, H, vh)."""
    pos = (torch.as_tensor(valid) - 1).reshape(1, 1).expand(
        q_nope.shape[0], 1)
    return L._expanded_attention(
        q_nope[:, None], q_rope[:, None], c_kv.to(q_nope.dtype),
        k_rope.to(q_nope.dtype), p, scale, positions=pos, k_positions=None,
        valid=valid)[:, 0]


def f32_params(tree):
    """The parameters with every floating leaf widened to f32: the model
    then rounds nowhere but where it writes its cache."""
    return {k: f32_params(v) if isinstance(v, dict)
            else v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def no_less_precise(ref, got, truth):
    """``got``'s logits (B, T, vocab) are as close to the f32 evaluation
    ``truth`` as the reference's ``ref`` are: the median over positions
    of the per-position RMS difference no more than 1.1 times the
    reference's (the median, so that a router near-tie settled otherwise
    at one position does not decide)."""
    def err(x):
        return float(np.median(np.sqrt(np.mean((x - truth) ** 2, -1))))
    assert err(got) <= 1.1 * err(ref), (err(got), err(ref))
