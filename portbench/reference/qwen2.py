"""Plain float32 Qwen2 decoder (GQA with QKV bias, SwiGLU, RMSNorm, tied
or untied head), for the benchmark's reference.

Follows the published architecture (Qwen/Qwen2-0.5B ``config.json``,
``modeling_qwen2.py``), read from the configuration file's published
keys.  Departures, as the configuration file states them: the RMSNorm
gain is stored as ``1 + scale``, and the rotary base is the file's
``rope_theta``.  Weights come in the layout the benchmark draws them in
(``portbench/weights.py``): per-layer leaves stacked on a leading axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .common import (
    Numerics, attention, cache_views, fp32_matmul, rmsnorm, rope, swiglu,
)

PAGED_KINDS = ("k", "v")


def forward(conf: dict, params: dict, tokens: torch.Tensor, *,
            prompt_len: int, out_positions: Sequence[int],
            schedule: Optional[Dict] = None, page_tokens: int = 64,
            numerics: str = "f32") -> torch.Tensor:
    """Logits (B, len(out_positions), vocab) float32 of ``tokens`` (B, S):
    a prompt of ``prompt_len`` positions and the tokens fed to the decode
    steps after it; with ``schedule`` (:func:`policy.schedule`) each
    query reads the spilled K/V pages at their view from the step the
    cache holds it."""
    num = Numerics(numerics)
    d = conf["hidden_size"]
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // H
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    n_layers = conf["num_hidden_layers"]
    B, S = tokens.shape
    dev = params["embed"].device
    pos = torch.arange(S, device=dev)
    cvs = cache_views(schedule, n_layers, PAGED_KINDS, S, page_tokens, dev)
    lp = params["layers"]
    with torch.no_grad(), fp32_matmul():
        x = params["embed"][tokens.to(dev)].float()
        for i in range(n_layers):
            a = lp["attn"]
            h = rmsnorm(x, a["norm"]["scale"][i], eps)
            q = num.mm(h, num.w(a["wq"][i])) + a["bq"][i].float()
            k = num.mm(h, num.w(a["wk"][i])) + a["bk"][i].float()
            v = num.mm(h, num.w(a["wv"][i])) + a["bv"][i].float()
            q = rope(q.view(B, S, H, hd), pos, theta)
            k = num.a(rope(k.view(B, S, KV, hd), pos, theta))
            v = num.a(v.view(B, S, KV, hd))
            ck, cv = cvs[(i, "k")], cvs[(i, "v")]
            o = attention(q, k, v, prompt_len=prompt_len,
                          k_view=None if ck.empty else ck.apply(k),
                          v_view=None if cv.empty else cv.apply(v),
                          cv_k=ck, cv_v=cv)
            x = x + num.mm(o.reshape(B, S, H * hd), num.w(a["wo"][i]))
            m = lp["mlp"]
            h = rmsnorm(x, m["norm"]["scale"][i], eps)
            x = x + swiglu(h, num.w(m["w1"][i]), num.w(m["w3"][i]),
                           num.w(m["w2"][i]), num)
        x = x[:, list(out_positions)]
        x = rmsnorm(x, params["final_norm"]["scale"], eps)
        head = (params["embed"].T if conf["tie_word_embeddings"]
                else params["lm_head"])
        return num.mm(x, num.w(head))
