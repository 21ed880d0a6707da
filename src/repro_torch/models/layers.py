"""Model building blocks of the token decoders: RMSNorm / LayerNorm,
RoPE, GQA and MLA attention, the SwiGLU / squared-ReLU / GELU MLPs and
the top-k MoE with shared experts, as functions on tensors.

Numerics follow the reference's bf16 graph op for op (f32 norm
statistics, f32 rotary angles, f32 attention scores and softmax, bf16
activations between blocks), so the two frameworks differ only where
bf16 rounds at other places inside a fused op.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.decode_attn import decode_attention

_MASKED = -1e30


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    """``1.0 + scale`` rounds in the scale's dtype (bf16), as the
    reference's weakly-typed scalar add does; the bias adds in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale).float() + bias.float()).to(x.dtype)


def norm(x, p, kind: str):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


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


def _const(v: float, like):
    """A scalar rounded to ``like``'s dtype first, as the reference's
    weakly-typed scalars are (PyTorch keeps a Python scalar in f32).  A
    0-d host tensor, which an op on the card takes as a scalar: no copy
    to the card, no wait on it."""
    return torch.tensor(v, dtype=like.dtype)


def _scale(q) -> float:
    """The attention scale ``hd**-0.5``, rounded to q's dtype as the
    reference's weakly-typed scalar is.  The reference's compiled graph
    then multiplies q by it in f32 and feeds the product to the f32
    score dot unrounded (XLA drops the bf16 round trip), so the port
    scales in f32 too."""
    return float(_const(q.shape[-1] ** -0.5, q))


def attention(q, k, v, *, q_positions, kv_valid_len: Optional[int] = None,
              q_chunk: int = 0):
    """Causal GQA attention over a cache (plain PyTorch; the prefill path).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0; cache slot
    ``t`` sits at position ``t``.  ``kv_valid_len`` masks slots at or past
    it; ``q_chunk`` > 0 processes query chunks to bound score memory.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = (q.float() * _scale(q)).reshape(B, Sq, KV, H // KV, hd)
    k_pos = torch.arange(Sk, device=q.device)
    kf, vf = k.float(), v.float()

    def block(qb, qpos):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kf)
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
    h = norm(x, p["norm"], cfg.norm)
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
        o = decode_attention(q[:, 0].contiguous(), kc, vc,
                             valid_len=cache_pos + 1, scale=_scale(q))
        out = o.to(q.dtype)
    else:
        out = attention(q, kc.to(k.dtype), vc.to(v.dtype),
                        q_positions=positions, kv_valid_len=cache_pos + S,
                        q_chunk=256 if S > 1024 else 0)
    return out.reshape(B, S, H * hd) @ p["wo"]


def mla_block(x, p, cfg, *, positions, cache, cache_pos: int):
    """DeepSeek-V2 multi-head latent attention over a latent cache.

    The cache holds this layer's ``c_kv`` (B, Smax, kv_lora_rank) latent
    and shared rope key ``k_rope`` (B, Smax, 1, qk_rope_dim), written in
    place at ``cache_pos``; K and V are re-expanded from the whole latent
    cache every step and attended in plain PyTorch (K is hd + rd wide, V
    ``v_head_dim``), as the reference does.
    """
    B, S, _ = x.shape
    H, hd, r = cfg.n_heads, cfg.hd, cfg.kv_lora_rank
    rd, vh = cfg.qk_rope_dim, cfg.v_head_dim or cfg.hd
    h = norm(x, p["norm"], cfg.norm)
    q = (h @ p["wq"]).reshape(B, S, H, hd + rd)
    q_rope = rope(q[..., hd:], positions, cfg.rope_theta)
    ckv_full = h @ p["w_dkv"]                              # (B, S, r + rd)
    c_kv = rmsnorm(ckv_full[..., :r], p["kv_norm"]["scale"])
    k_rope = rope(ckv_full[..., None, r:], positions, cfg.rope_theta)
    cc, kc = cache["c_kv"], cache["k_rope"]
    cc[:, cache_pos : cache_pos + S] = c_kv.to(cc.dtype)
    kc[:, cache_pos : cache_pos + S] = k_rope.to(kc.dtype)
    c_all, k_rope_all = cc.to(h.dtype), kc.to(h.dtype)
    Sk = c_all.shape[1]
    k_nope = (c_all @ p["w_uk"]).reshape(B, Sk, H, hd)
    v = (c_all @ p["w_uv"]).reshape(B, Sk, H, vh)
    k = torch.cat([k_nope, k_rope_all.expand(B, Sk, H, rd)], dim=-1)
    qfull = torch.cat([q[..., :hd], q_rope], dim=-1)
    out = attention(qfull, k, v, q_positions=positions,
                    kv_valid_len=cache_pos + S,
                    q_chunk=256 if S > 1024 else 0)
    return out.reshape(B, S, H * vh) @ p["wo"]


def silu(a):
    """``x * sigmoid(x)`` rounded to the input dtype after every op, as
    the reference's bf16 graph computes it (``F.silu`` rounds once)."""
    return a * (1 / (1 + torch.exp(-a)))


def gelu(a):
    """``jax.nn.gelu``'s default tanh form, rounded after every op as the
    reference computes it in bf16."""
    cube = a * a * a
    inner = _const(np.sqrt(2 / np.pi), a) * (a + _const(0.044715, a) * cube)
    return a * (0.5 * (1 + torch.tanh(inner)))


def mlp_apply(h, p, kind: str):
    if kind == "swiglu":
        z = silu(h @ p["w1"]) * (h @ p["w3"])
    elif kind == "squared_relu":
        z = F.relu(h @ p["w1"]).square()
    else:
        z = gelu(h @ p["w1"])
    return z @ p["w2"]


def mlp_block(x, p, cfg):
    """Pre-norm MLP (``cfg.mlp``: swiglu | squared_relu | gelu)."""
    return mlp_apply(norm(x, p["norm"], cfg.norm), p, cfg.mlp)


def _expert_ffn(buf, p, cfg):
    """Every expert on its rows: ``buf`` (E, n, d) → (E, n, d).  Like the
    reference's expert path, any MLP other than swiglu takes GELU."""
    if cfg.mlp == "swiglu":
        z = silu(buf @ p["w1"]) * (buf @ p["w3"])
    else:
        z = gelu(buf @ p["w1"])
    return z @ p["w2"]


def route(flat, router, k: int):
    """Top-k routing: f32 softmax of the bf16 router logits, the k largest
    probabilities (ties to the lower expert index, as ``jax.lax.top_k``
    takes them, through a stable descending sort) and their gates
    renormalised to sum to 1.  Returns ``(gates (T, k) f32, experts (T,
    k) int64)``."""
    probs = torch.softmax((flat @ router).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    return gates / gates.sum(-1, keepdim=True), experts


def capacity_slots(experts, n_experts: int, cap: int):
    """Each (token, choice)'s slot in its expert's capacity buffer, by a
    cumulative count over the (T·k, E) one-hot in row-major order, and
    whether the slot is below ``cap`` (``keep``; the rest are dropped)."""
    T, k = experts.shape
    onehot = F.one_hot(experts.reshape(-1), n_experts)
    pos = (onehot.cumsum(0) - 1).gather(1, experts.reshape(-1, 1))
    pos = pos.reshape(T, k)
    return pos, pos < cap


def _moe_dense_decode(flat, p, cfg, gates, experts):
    """Few tokens (S == 1): every expert on every token, combined by an
    f32 scatter-add of the gates — exact, no capacity drops."""
    T = flat.shape[0]
    y_all = _expert_ffn(flat.expand(cfg.n_experts, T, -1), p, cfg)  # (E,T,d)
    weight = torch.zeros(T, cfg.n_experts, dtype=torch.float32,
                         device=flat.device)
    weight.scatter_add_(1, experts, gates)
    return torch.einsum("etd,te->td", y_all, weight.to(flat.dtype))


def moe_block(x, p, cfg):
    """Pre-norm token-choice top-k MoE plus the shared experts.

    A prompt (S > 1) packs each (token, choice) into its expert's
    capacity buffer of ``int(max(1, capacity_factor * k * T / E))`` rows,
    dropping the overflow in the reference's cumsum order, and combines
    the expert outputs weighted by the gates; a single token takes the
    dense path.  The training-only aux loss is not computed.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    h = norm(x, p["norm"], cfg.norm)
    flat = h.reshape(B * S, d)
    T = B * S
    gates, experts = route(flat, p["router"], k)
    if S == 1:
        out = _moe_dense_decode(flat, p, cfg, gates, experts)
    else:
        cap = int(max(1, cfg.capacity_factor * k * T / E))
        pos, keep = capacity_slots(experts, E, cap)
        buf = torch.zeros(E, cap, d, dtype=x.dtype, device=x.device)
        rows = flat.repeat_interleave(k, dim=0)[keep.reshape(-1)]
        buf[experts[keep], pos[keep]] = rows
        y_buf = _expert_ffn(buf, p, cfg)                      # (E, cap, d)
        gathered = torch.zeros(T, k, d, dtype=x.dtype, device=x.device)
        gathered[keep] = y_buf[experts[keep], pos[keep]]
        out = (gathered * gates[..., None].to(x.dtype)).sum(dim=1)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_apply(h, p["shared"], cfg.mlp)
    return out
