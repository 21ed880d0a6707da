"""Plain float32 DeepSeek-V3 decoder (multi-head latent attention with a
query LoRA and YaRN, leading dense layers, sigmoid group-limited routing
over the published experts, of which this chip computes its block, and a
shared expert), for the benchmark's reference.

Follows the published architecture (deepseek-ai/DeepSeek-V3
``config.json``, ``modeling_deepseek.py``), read from the configuration
file's published keys; the pieces it shares with DeepSeek-V2 (YaRN, the
experts' loop, attention over the cache's views) are
``deepseek_v2.py``'s.  Departures, as the configuration file states them:

* bfloat16 weights, drawn from the seed (``portbench/weights.py``), for
  the published FP8 checkpoint, one layer's cast to float32 at a time;
* a prompt's tokens are routed through expert buffers of
  ``int(capacity_factor * top_k * tokens / published experts)`` rows,
  which drop the overflow in token order (``assumed``: the port's prefill
  does; the published model drops none); a decode step's tokens are never
  dropped;
* the expert share: the router scores all ``published.n_routed_experts``
  experts, and only the ``n_routed_experts`` held here,
  [``expert_offset``, ``expert_offset + n_routed_experts``), add their
  part; what the other chips' experts would add is left out, as in the
  program;
* the depth cut to ``num_hidden_layers`` (the rest lie on further
  pipeline stages), and no multi-token prediction module;
* the rotary halves are taken as halves (the published code permutes
  interleaved pairs into halves first), and the RMSNorm gain is stored
  as ``1 + scale``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .common import (
    Numerics, attention, cache_views, fp32_matmul, rmsnorm, rope, swiglu,
)
from .deepseek_v2 import _experts, yarn

PAGED_KINDS = ("c_kv",)


def _mla(x, a, i, conf, pos, prompt_len, cv, num):
    """Latent attention, the query through ``wq_a``, its RMSNorm and
    ``wq_b``."""
    B, S, _ = x.shape
    H = conf["num_attention_heads"]
    dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    dv, r = conf["v_head_dim"], conf["kv_lora_rank"]
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    freqs, gain, soft = yarn(conf)
    h = rmsnorm(x, a["norm"]["scale"][i], eps)
    cq = rmsnorm(num.mm(h, num.w(a["wq_a"][i])), a["q_norm"]["scale"][i],
                 eps)
    q = num.mm(cq, num.w(a["wq_b"][i])).view(B, S, H, dn + dr)
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


def route(flat, router, bias, conf):
    """``noaux_tc``: sigmoid scores; the biased scores choose the top
    ``topk_group`` of ``n_group`` groups (each scored by its top 2) and
    the top ``num_experts_per_tok`` experts within them (ties to the lower
    index); the gates are the unbiased scores, renormalised
    (``norm_topk_prob``), times ``routed_scaling_factor``.  ``experts``
    are numbered over the whole router."""
    T, E = flat.shape[0], router.shape[-1]
    G, k = conf["n_group"], conf["num_experts_per_tok"]
    scores = torch.sigmoid(flat @ router)
    biased = scores + bias
    group = biased.view(T, G, E // G).topk(2, dim=-1).values.sum(-1)
    chosen = torch.sort(group, dim=-1, descending=True,
                        stable=True).indices[:, :conf["topk_group"]]
    in_group = torch.zeros(T, G, dtype=torch.bool, device=flat.device)
    in_group[torch.arange(T, device=flat.device)[:, None], chosen] = True
    allowed = in_group[:, torch.arange(E, device=flat.device) // (E // G)]
    experts = torch.sort(biased.masked_fill(~allowed, float("-inf")), dim=-1,
                         descending=True, stable=True).indices[:, :k]
    gates = scores.gather(1, experts)
    if conf["norm_topk_prob"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * conf["routed_scaling_factor"], experts


def _moe(x, m, i, conf, prompt_len, num):
    """Routed experts over the prompt's tokens (through the uncut layer's
    capacity buffers, all sequences' tokens together in batch-major
    order) and over the decode steps' tokens (never dropped), of which
    the held block adds its part, plus the shared expert."""
    B, S, d = x.shape
    E = conf["published"]["n_routed_experts"]
    k = conf["num_experts_per_tok"]
    lo_e = conf["expert_offset"]
    h = rmsnorm(x, m["norm"]["scale"][i], conf["rms_norm_eps"])
    router, bias = num.w(m["router"][i]), m["router_bias"][i].float()
    out = torch.empty_like(h)
    for lo, hi, capped in ((0, prompt_len, True), (prompt_len, S, False)):
        if hi <= lo:
            continue
        flat = h[:, lo:hi].reshape(-1, d)
        gates, experts = route(num.a(flat), router, bias, conf)
        if capped:
            T = flat.shape[0]
            cap = int(max(1, conf["capacity_factor"] * k * T / E))
            onehot = torch.nn.functional.one_hot(experts.reshape(-1), E)
            slot = (onehot.cumsum(0) - 1).gather(
                1, experts.reshape(-1, 1)).view(T, k)
            keep = slot < cap
        else:
            keep = torch.ones_like(experts, dtype=torch.bool)
        local = experts - lo_e
        keep = keep & (local >= 0) & (local < conf["n_routed_experts"])
        y = _experts(flat, gates, local, keep, m, i, num)
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
