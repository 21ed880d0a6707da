"""Frozen yardstick of a decode step's least memory traffic, from the
configuration's published sizes, whatever implements the step.

A step of ``batch`` sequences must read at least, once each: every
weight the chip holds that every step needs (the attention, the dense
layers' MLPs, the router and its correction bias, the shared experts,
the norms, the output head), the embedding's ``batch`` rows, and each
sequence's cached latent (``c_kv`` and ``k_rope``) over its context, in
every layer.  Routed experts' weights are left out: a step may route no
token to an expert, and then need not read it.  Weights and cache are
counted in bfloat16, as they are served.
"""

from __future__ import annotations

ELEM = 2                     # bytes of a bfloat16 weight or cache word


def _router_width(conf: dict) -> int:
    """Experts the router scores: the published count, where the chip
    holds a share of them."""
    return conf.get("published", {}).get("n_routed_experts",
                                         conf["n_routed_experts"])


def attn_params(conf: dict) -> int:
    """One latent-attention layer's weights and norm gains."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    dv, r = conf["v_head_dim"], conf["kv_lora_rank"]
    qr = conf.get("q_lora_rank") or 0
    q = d * qr + qr + qr * H * (dn + dr) if qr else d * H * (dn + dr)
    return d + q + d * (r + dr) + r + r * H * (dn + dv) + H * dv * d


def step_weight_params(conf: dict) -> int:
    """Weights every decode step reads, in elements."""
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    n_dense = conf["first_k_dense_replace"]
    E = _router_width(conf)
    bias = E if conf.get("topk_method") == "noaux_tc" else 0
    shared = 3 * d * conf["moe_intermediate_size"] * conf["n_shared_experts"]
    dense_mlp = d + 3 * d * conf["intermediate_size"]
    moe = d + d * E + bias + shared
    head = 0 if conf.get("tie_word_embeddings") else d * conf["vocab_size"]
    return (L * attn_params(conf) + n_dense * dense_mlp
            + (L - n_dense) * moe + d + head)


def cache_bytes_per_token(conf: dict) -> int:
    """A sequence's cached latent for one position, every layer."""
    return conf["num_hidden_layers"] * (conf["kv_lora_rank"]
                                        + conf["qk_rope_head_dim"]) * ELEM


def decode_step_bytes(conf: dict, batch: int, position: int) -> int:
    """The least bytes of one decode step feeding ``position`` (so over a
    context of ``position + 1``) in each of ``batch`` sequences."""
    return ELEM * step_weight_params(conf) + batch * (
        ELEM * conf["hidden_size"]
        + cache_bytes_per_token(conf) * (position + 1))
