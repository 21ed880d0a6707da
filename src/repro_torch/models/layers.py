"""Model building blocks of the dense GQA decoder: RMSNorm, RoPE, GQA
attention and the SwiGLU MLP, as functions on tensors.

Numerics follow the reference's bf16 graph op for op (f32 norm
statistics, f32 rotary angles, f32 attention scores and softmax, bf16
activations between blocks), so the two frameworks differ only where
bf16 rounds at other places inside a fused op.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.decode_attn import decode_attention

_MASKED = -1e30


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (B, S, half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _scaled(q):
    """``q * hd**-0.5`` with the scale rounded to q's dtype first, as the
    reference's weakly-typed scalar multiply rounds it."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype, device=q.device)
    return q * scale


def attention(q, k, v, *, q_positions, kv_valid_len: Optional[int] = None,
              q_chunk: int = 0):
    """Causal GQA attention over a cache (plain PyTorch; the prefill path).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0; cache slot
    ``t`` sits at position ``t``.  ``kv_valid_len`` masks slots at or past
    it; ``q_chunk`` > 0 processes query chunks to bound score memory.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = _scaled(q).reshape(B, Sq, KV, H // KV, hd)
    k_pos = torch.arange(Sk, device=q.device)
    kf, vf = k.float(), v.float()

    def block(qb, qpos):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qb.float(), kf)
        m = k_pos[None, None, None, None, :] <= qpos[:, None, None, :, None]
        if kv_valid_len is not None:
            m = m & (k_pos < kv_valid_len)
        s = torch.where(m, s, torch.full_like(s, _MASKED))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
        return o.to(q.dtype)

    qpos = q_positions.expand(B, Sq)
    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        out = torch.cat([block(qg[:, i : i + q_chunk], qpos[:, i : i + q_chunk])
                         for i in range(0, Sq, q_chunk)], dim=1)
    else:
        out = block(qg, qpos)
    return out.reshape(B, Sq, H, v.shape[-1])


def gqa_block(x, p, cfg, *, positions, cache, cache_pos: int):
    """norm → qkv (+bias, +rope) → cache write → attention → out proj.

    ``cache`` holds this layer's ``k``/``v`` (B, Smax, KV, hd) tensors,
    updated in place at ``cache_pos``.  One token (S == 1) attends through
    the decode-attention kernel; a prompt (S > 1) through plain PyTorch.
    """
    B, S, _ = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, p["norm"]["scale"])
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, KVh, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KVh, hd)
    kc, vc = cache["k"], cache["v"]
    kc[:, cache_pos : cache_pos + S] = k.to(kc.dtype)
    vc[:, cache_pos : cache_pos + S] = v.to(vc.dtype)
    if S == 1:
        o = decode_attention(_scaled(q[:, 0]).contiguous(), kc, vc,
                             valid_len=cache_pos + 1, scale=1.0)
        out = o.to(q.dtype)
    else:
        out = attention(q, kc.to(k.dtype), vc.to(v.dtype),
                        q_positions=positions, kv_valid_len=cache_pos + S,
                        q_chunk=256 if S > 1024 else 0)
    return out.reshape(B, S, H * hd) @ p["wo"]


def mlp_block(x, p, cfg):
    """Pre-norm SwiGLU MLP."""
    if cfg.mlp != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp!r}: only swiglu is ported")
    h = rmsnorm(x, p["norm"]["scale"])
    return (F.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
