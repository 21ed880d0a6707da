"""Plain float32 DeepSeek-V2 decoder (multi-head latent attention without
a query LoRA, leading dense layers, routed experts with shared experts),
for the benchmark's reference.

Follows the published architecture (deepseek-ai/DeepSeek-V2-Lite
``config.json``, ``modeling_deepseek.py``), read from the configuration
file's published keys.  Departures, as the configuration file states
them: the top-k gates are renormalised (``norm_topk_prob``), YaRN's
``rope_scaling`` has the factor 1, which leaves the plain rotary
embedding and softmax scale (:func:`yarn` works any factor out as the
published code does), the rotary halves are taken as halves (the published code first permutes interleaved pairs into halves:
the same up to a fixed order of the projection's columns), the RMSNorm
gain is stored as ``1 + scale``, and a prompt's tokens are routed through
expert buffers of ``capacity_factor * top_k * tokens / experts`` rows,
which drop the overflow in token order (``assumed``: the port's prefill
does; a decode step's tokens are never dropped).  Weights come in the
layout the benchmark draws them in (``portbench/weights.py``), one
layer's cast to float32 at a time.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from .common import (
    Numerics, attention, cache_views, fp32_matmul, rmsnorm, rope, swiglu,
)

PAGED_KINDS = ("c_kv",)


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn(conf: dict) -> Tuple[Optional[torch.Tensor], float, float]:
    """DeepSeek-V2's YaRN from ``rope_scaling`` (``modeling_deepseek.py``,
    ``DeepseekV2YarnRotaryEmbedding`` and the attention's softmax scale):
    the rotary frequencies (None: ``rope_theta``'s), the gain on cos and
    sin, and the gain on the softmax scale.  A factor of 1 or less leaves
    all three plain."""
    rs = conf.get("rope_scaling")
    if not rs or rs["factor"] <= 1:
        return None, 1.0, 1.0
    if rs["type"] != "yarn":
        raise ValueError(f"rope_scaling type {rs['type']!r}")
    factor, base, dim = rs["factor"], conf["rope_theta"], \
        conf["qk_rope_head_dim"]
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))

    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    hi = hi + 0.001 if lo == hi else hi
    extra = base ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo)
            / (hi - lo)).clamp(0, 1)
    freqs = extra / factor * ramp + extra * (1 - ramp)
    m_all = rs.get("mscale_all_dim", 0)
    gain = _yarn_mscale(factor, rs.get("mscale", 1)) \
        / _yarn_mscale(factor, m_all)
    soft = _yarn_mscale(factor, m_all) ** 2 if m_all else 1.0
    return freqs, gain, soft


def _mla(x, a, i, conf, pos, prompt_len, cv, num):
    B, S, _ = x.shape
    H = conf["num_attention_heads"]
    dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    dv, r = conf["v_head_dim"], conf["kv_lora_rank"]
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    freqs, gain, soft = yarn(conf)
    h = rmsnorm(x, a["norm"]["scale"][i], eps)
    q = num.mm(h, num.w(a["wq"][i])).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta, freqs=freqs,
                                     gain=gain)], dim=-1)
    ckv = num.mm(h, num.w(a["w_dkv"][i]))
    c = num.a(rmsnorm(ckv[..., :r], a["kv_norm"]["scale"][i], eps))
    k_rope = num.a(rope(ckv[..., None, r:], pos, theta, freqs=freqs,
                        gain=gain))
    w_uk, w_uv = num.w(a["w_uk"][i]), num.w(a["w_uv"][i])

    def expand(lat):
        k = torch.cat([num.mm(lat, w_uk).view(B, S, H, dn),
                       k_rope.expand(B, S, H, dr)], dim=-1)
        return k, num.mm(lat, w_uv).view(B, S, H, dv)

    k, v = expand(c)
    kv_view = (None, None) if cv is None or cv.empty else expand(cv.apply(c))
    o = attention(q, k, v, prompt_len=prompt_len, k_view=kv_view[0],
                  v_view=kv_view[1], cv_k=cv, cv_v=cv, scale_gain=soft)
    return num.mm(o.reshape(B, S, H * dv), num.w(a["wo"][i]))


def _route(flat, router, k: int, renorm: bool):
    probs = torch.softmax(flat @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    if renorm:
        gates = gates / gates.sum(-1, keepdim=True)
    return gates, experts


def _experts(flat, gates, experts, keep, m, i, num):
    """Sum over each token's kept choices of gate x expert(token)."""
    out = torch.zeros_like(flat)
    for e in range(m["w1"].shape[1]):
        tok, choice = torch.nonzero((experts == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(flat[tok], num.w(m["w1"][i, e]), num.w(m["w3"][i, e]),
                   num.w(m["w2"][i, e]), num)
        out.index_add_(0, tok, y * gates[tok, choice, None])
    return out


def _moe(x, m, i, conf, prompt_len, num):
    """Routed experts over the prompt's tokens (through capacity buffers,
    all sequences' tokens together in batch-major order) and over the
    decode steps' tokens (never dropped), plus the shared experts."""
    B, S, d = x.shape
    E, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    h = rmsnorm(x, m["norm"]["scale"][i], conf["rms_norm_eps"])
    router = num.w(m["router"][i])
    out = torch.empty_like(h)
    for lo, hi, capped in ((0, prompt_len, True), (prompt_len, S, False)):
        if hi <= lo:
            continue
        flat = h[:, lo:hi].reshape(-1, d)
        gates, experts = _route(num.a(flat), router, k,
                                conf["norm_topk_prob"])
        if capped:
            T = flat.shape[0]
            cap = int(max(1, conf["capacity_factor"] * k * T / E))
            onehot = torch.nn.functional.one_hot(experts.reshape(-1), E)
            slot = (onehot.cumsum(0) - 1).gather(
                1, experts.reshape(-1, 1)).view(T, k)
            keep = slot < cap
        else:
            keep = torch.ones_like(experts, dtype=torch.bool)
        y = _experts(flat, gates, experts, keep, m, i, num)
        out[:, lo:hi] = y.view(B, hi - lo, d)
    sh = m["shared"]
    return out + swiglu(h, num.w(sh["w1"][i]), num.w(sh["w3"][i]),
                        num.w(sh["w2"][i]), num)


def forward(conf: dict, params: dict, tokens: torch.Tensor, *,
            prompt_len: int, out_positions: Sequence[int],
            schedule: Optional[Dict] = None, page_tokens: int = 64,
            numerics: str = "f32") -> torch.Tensor:
    """Logits (B, len(out_positions), vocab) float32 of ``tokens`` (B, S):
    a prompt of ``prompt_len`` positions and the tokens fed to the decode
    steps after it; with ``schedule`` (:func:`policy.schedule`, over the
    layers after the leading dense ones, whose latents are paged) each
    query reads the spilled latent pages at their view from the step the
    cache holds it."""
    num = Numerics(numerics)
    n_dense = conf["first_k_dense_replace"]
    n_layers = conf["num_hidden_layers"]
    eps = conf["rms_norm_eps"]
    B, S = tokens.shape
    dev = params["embed"].device
    pos = torch.arange(S, device=dev)
    cvs = cache_views(schedule, n_layers - n_dense, PAGED_KINDS, S,
                      page_tokens, dev)
    with torch.no_grad(), fp32_matmul():
        x = params["embed"][tokens.to(dev)].float()
        for li in range(n_layers):
            dense = li < n_dense
            part = params["dense0" if dense else "layers"]
            i = li if dense else li - n_dense
            cv = None if dense else cvs[(i, "c_kv")]
            x = x + _mla(x, part["attn"], i, conf, pos, prompt_len, cv, num)
            if dense:
                m = part["mlp"]
                h = rmsnorm(x, m["norm"]["scale"][i], eps)
                x = x + swiglu(h, num.w(m["w1"][i]), num.w(m["w3"][i]),
                               num.w(m["w2"][i]), num)
            else:
                x = x + _moe(x, part["moe"], i, conf, prompt_len, num)
        x = x[:, list(out_positions)]
        x = rmsnorm(x, params["final_norm"]["scale"], eps)
        return num.mm(x, num.w(params["lm_head"]))
