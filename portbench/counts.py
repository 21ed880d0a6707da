"""Frozen yardstick: the H100's published peaks and the functions that
count the operations and bytes a piece of work needs, from its shapes and
the configuration's published sizes, whatever implements it.

The peaks are NVIDIA's data sheet for the SXM part at its 700 W limit
(dense rates); ``bound_ms``, ``attn_bound`` and ``match_bytes`` are the
port's own count functions, copied as they stood when the benchmark was
defined.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_S = 67e12          # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS_S = 989e12        # H100 SXM dense bf16 tensor-core rate


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS_S) -> tuple:
    """The least time for the work: bytes over the memory rate or
    operations over ``peak``, whichever is larger, and which."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bound(valid: int, heads: int, kv_heads: int, hd: int) -> tuple:
    """Bound of one bf16 decode-attention call: K and V rows below
    ``valid`` read once, q read and the f32 output written once."""
    nbytes = 2 * valid * kv_heads * hd * 2 + heads * hd * 2 + heads * hd * 4
    return bound_ms(nbytes, 4 * heads * valid * hd)


def match_bytes(starts, ends, n_events: int, blocks: int) -> tuple:
    """Bytes the LZ4 match kernel must move, ``(now, before)``: now each
    stream's bytes (1 B a position), its five int64 meta entries and its
    int32 count, each block's first stream (int64), and 12 B (pos, dist,
    mlen) an event; before (the prep's words and hashes read by a
    separate match launch), of each stream longer than MFLIMIT + 1 bytes
    the int32 word and hash of its L - 3 positions, four int64 meta
    entries and the count of every stream, and the events."""
    L = np.asarray(ends) - np.asarray(starts)
    now = int(L.sum() + 44 * L.size + 8 * (blocks + 1) + 12 * n_events)
    before = int(8 * (L - 3)[L > 13].sum() + 36 * L.size + 12 * n_events)
    return now, before


# -- the tier ------------------------------------------------------------------

def tier_write_bytes(raw: int, stored: int) -> int:
    """A spill's least traffic: the raw window bytes read once and the
    stored bytes written once."""
    return raw + stored


def tier_read_bytes(stored: int, decoded: int) -> int:
    """A readback's least traffic: the stored bytes read once and the
    decoded words written once."""
    return stored + decoded


def tier_least_s(write_bytes: int, read_bytes: int) -> float:
    """The least device time of the tier's work: its bytes at the HBM
    rate."""
    return (write_bytes + read_bytes) / HBM_BYTES_S


# -- the model -----------------------------------------------------------------

def _layer_params(conf: dict) -> tuple:
    """``(params a token needs in each dense layer, in each expert layer,
    number of dense layers, number of expert layers)`` from the published
    sizes: routed experts counted at ``num_experts_per_tok``."""
    d = conf["hidden_size"]
    H = conf["num_attention_heads"]
    L = conf["num_hidden_layers"]
    if conf.get("kv_lora_rank"):
        dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
        dv, r = conf["v_head_dim"], conf["kv_lora_rank"]
        attn = d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) \
            + H * dv * d
    else:
        hd = d // H
        kv = conf["num_key_value_heads"] * hd
        attn = 2 * d * H * hd + 2 * d * kv
    dense = attn + 3 * d * conf["intermediate_size"]
    n_dense = conf.get("first_k_dense_replace", L) if conf.get(
        "n_routed_experts") else L
    if not conf.get("n_routed_experts"):
        return dense, 0, L, 0
    f = conf["moe_intermediate_size"]
    k, shared = conf["num_experts_per_tok"], conf.get("n_shared_experts", 0)
    moe = attn + d * conf["n_routed_experts"] + 3 * d * f * (k + shared)
    return dense, moe, n_dense, L - n_dense


def attn_dims(conf: dict) -> tuple:
    """``(query-key width, value width)`` of one head."""
    if conf.get("kv_lora_rank"):
        return (conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"],
                conf["v_head_dim"])
    hd = conf["hidden_size"] // conf["num_attention_heads"]
    return hd, hd


def token_flops(conf: dict, context: int, logits: bool) -> float:
    """The model's operations for one token that attends to ``context``
    positions (itself included): 2 per weight it needs, the attention's
    products over its context in every layer, and the output head when
    its logits are needed."""
    dense, moe, n_dense, n_moe = _layer_params(conf)
    dq, dv = attn_dims(conf)
    H, L = conf["num_attention_heads"], conf["num_hidden_layers"]
    flops = 2.0 * (dense * n_dense + moe * n_moe)
    flops += 2.0 * L * H * context * (dq + dv)
    if logits:
        flops += 2.0 * conf["hidden_size"] * conf["vocab_size"]
    return flops


def prefill_flops(conf: dict, batch: int, prompt_len: int) -> float:
    """A prompt of ``prompt_len`` tokens in each of ``batch`` sequences,
    with the last position's logits."""
    dense, moe, n_dense, n_moe = _layer_params(conf)
    dq, dv = attn_dims(conf)
    H, L = conf["num_attention_heads"], conf["num_hidden_layers"]
    linear = 2.0 * (dense * n_dense + moe * n_moe) * prompt_len
    ctx = prompt_len * (prompt_len + 1) / 2
    attn = 2.0 * L * H * ctx * (dq + dv)
    head = 2.0 * conf["hidden_size"] * conf["vocab_size"]
    return batch * (linear + attn + head)


def decode_flops(conf: dict, batch: int, position: int) -> float:
    """One decode step feeding ``position`` in each of ``batch``
    sequences."""
    return batch * token_flops(conf, position + 1, True)
