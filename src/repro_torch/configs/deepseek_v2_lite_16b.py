"""DeepSeek-V2-Lite 16B — MLA attention (kv_lora=512) + fine-grained MoE.

Assigned spec says "MoE 64e top-6" in the shape line and "2 shared + 160
routed" in the note; we follow the primary 64-routed spec (the HF config's
160-expert variant is not modelled).  As in the reference, the top-k gates
are always renormalised (HF: ``norm_topk_prob: false``) and rope has no
YaRN scaling.  [arXiv:2405.04434; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,            # dense first layer FFN
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense=1,
    mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    v_head_dim=128,
    mlp="swiglu",
)
