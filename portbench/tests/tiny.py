"""Cells at a size a CPU test holds: each configuration's file with its
widths cut (the program section cut to match), and a traffic mix that
still spills pages, on the same harness, program and reference."""

from __future__ import annotations

import copy
import json

from portbench import registry

QWEN = "qwen2-0.5b"
DEEPSEEK = "deepseek-v2-lite-16b"

_CUTS = {
    QWEN: ({"hidden_size": 128, "intermediate_size": 256,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "num_hidden_layers": 2, "vocab_size": 512},
           {"d_model": 128, "d_ff": 256, "n_heads": 4, "n_kv_heads": 2,
            "n_layers": 2, "vocab": 512}),
    DEEPSEEK: ({"hidden_size": 128, "intermediate_size": 256,
                "num_attention_heads": 4, "num_hidden_layers": 3,
                "vocab_size": 512, "kv_lora_rank": 64,
                "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                "v_head_dim": 32, "n_routed_experts": 8,
                "n_shared_experts": 1, "num_experts_per_tok": 2,
                "moe_intermediate_size": 64},
               {"d_model": 128, "d_ff": 256, "n_heads": 4, "n_kv_heads": 4,
                "head_dim": 32, "n_layers": 3, "vocab": 512,
                "kv_lora_rank": 64, "qk_rope_dim": 16, "v_head_dim": 32,
                "n_experts": 8, "n_shared_experts": 1, "top_k": 2,
                "moe_d_ff": 64}),
}

# prompts of 2-4 pages of 16 tokens, 40 new tokens, a budget of a few pages
TRAFFIC = {"arrival": "closed", "batch": 2,
           "prompt_len": {"min": 32, "max": 64, "multiple": 16},
           "new_tokens": 40, "requests": 8, "page_tokens": 16,
           "hbm_kv_budget": 4 * 16 * 2 * 64 * 2, "tier": "trace",
           "policy": {"tiers": [[5, "bf16"], [3, "man4"], [2, "man0"]],
                      "tail": "man0"},
           "check": {"sampled_requests": 2}}

# set from the tiny cells' readings on this CPU (program against the
# float8 control, seeds 1-3): qwen's prefill gaps 0-0.017 against
# 0.12-0.50 and mean gaps 0-0.00016 against 0.0098-0.016; deepseek's
# mean gap 0.00015-0.011 against 0.10-0.14.  The numbers are the cells'
# own: neither compares the widest decode gap, which does not separate
# the program from the control at the cells' size
LIMITS = {
    QWEN: {"requests_checked": 1, "prefill_gap": 0.05, "gap_mean": 0.003,
           "tier_pages_off": 0, "tier_words_off": 0},
    DEEPSEEK: {"requests_checked": 1, "gap_mean": 0.03, "tier_pages_off": 0,
               "tier_words_off": 0},
}


def conf(model: str) -> dict:
    """``model``'s configuration file, cut to the tiny widths."""
    bench = registry.benchmark()
    c = copy.deepcopy(registry.config(bench, model))
    hf, prog = _CUTS[model]
    c.update(hf)
    c["program"].update(prog)
    return c


def bench_for(name: str, model: str, traffic_name: str = "tiny") -> dict:
    """A BENCHMARK.json holding one cell of ``model``."""
    bench = copy.deepcopy(registry.benchmark())
    bench["workloads"] = [{"name": name, "config": model,
                           "traffic": traffic_name, "chips": 1,
                           "why": "CPU test"}]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            m.pop("workloads", None)
    return bench


def cell(model: str, name: str = "tiny", **traffic):
    from portbench.harness import Cell

    t = json.loads(json.dumps(TRAFFIC))
    t.update(traffic)
    return Cell(bench_for(name, model), name, conf(model), t,
                dict(LIMITS[model]))
