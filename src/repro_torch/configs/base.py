"""Architecture config: the port's own copy of the reference's frozen
dataclass (the fields the PyTorch model reads, plus the rest so a
reference config carries over field for field).

Configs are pure data — ``models/`` builds parameters and step
functions from them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp: str = "swiglu"          # swiglu | squared_relu | gelu
    causal: bool = True          # False → encoder-only (no decode step)
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert FFN width (0 → use d_ff)
    moe_every: int = 1
    first_dense: int = 0         # leading dense layers (deepseek style)

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    v_head_dim: int = 0

    # SSM
    ssm: str = ""
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_heads: int = 0

    # hybrid
    attn_every: int = 0
    window: int = 0

    # modality frontend stub
    frontend: str = ""

    capacity_factor: float = 1.25

    # numerics
    remat: bool = True
    optimizer_dtype: str = "float32"
    # decode KV-cache storage dtype ("bfloat16" or "float8_e4m3fn")
    kv_dtype: str = "bfloat16"
    fsdp: bool = True
    decode_layout: str = "batch_dp"
    embed_vocab_shard: bool = True

    # --- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def uses_tokens(self) -> bool:
        return self.frontend == ""

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state or sliding-window hybrid."""
        return self.family in ("ssm", "hybrid")

    def kv_bytes_per_token(self, elem_bytes: int = 2) -> float:
        if self.ssm == "mamba1":
            return 0.0  # constant-size state, not per-token
        if self.mla:
            return (self.n_layers * (self.kv_lora_rank + self.qk_rope_dim)
                    * elem_bytes)
        n_attn = self.n_layers
        if self.attn_every:
            n_attn = self.n_layers // self.attn_every
        return n_attn * 2 * self.n_kv_heads * self.hd * elem_bytes


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a train step, a prompt's prefill or a decode
    step at ``seq_len`` tokens for ``global_batch`` sequences."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeConfig]:
    """The shape cells defined for ``cfg``: an encoder-only model has no
    decode step, and ``long_500k`` needs sub-quadratic attention (the
    SSM and hybrid families)."""
    out = [TRAIN_4K, PREFILL_32K]
    if not cfg.is_encoder_only:
        out.append(DECODE_32K)
        if cfg.supports_long_context:
            out.append(LONG_500K)
    return out


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (identical to the
    reference's reduction, so one seed's weights transfer between them)."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2 if not cfg.attn_every else cfg.attn_every),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        kv_lora_rank=64 if cfg.mla else 0,
        qk_rope_dim=16 if cfg.mla else 64,
        v_head_dim=32 if cfg.mla else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm == "mamba2" else 0,
        first_dense=min(cfg.first_dense, 1),
        capacity_factor=4.0,
        window=min(cfg.window, 64) if cfg.window else 0,
        remat=False,
    )
