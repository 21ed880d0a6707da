"""The benchmark's DeepSeek-V3 configuration and its decode step's byte
count: the program section agrees with the published keys it stands
for, and ``portbench/step_bytes.py`` counts what a hand reckoning of the
tiny cut gives, as ``decode_hbm_roofline`` reads it."""

import copy

import pytest

from portbench import counts, devtrace, harness, registry, step_bytes

MODEL = "deepseek-v3-671b"


def _conf():
    return registry.config(registry.benchmark(), MODEL)


def test_program_section_matches_the_new_published_keys():
    conf = _conf()
    prog, pub = conf["program"], conf["published"]
    rs = conf["rope_scaling"]
    assert (prog["q_lora_rank"], prog["n_group"], prog["topk_group"],
            prog["routed_scale"], prog["router_experts"],
            prog["expert_offset"], prog["scoring"]) == (
        conf["q_lora_rank"], conf["n_group"], conf["topk_group"],
        conf["routed_scaling_factor"], pub["n_routed_experts"],
        conf["expert_offset"], conf["scoring_func"])
    assert (prog["rope_factor"], prog["rope_original_max"],
            prog["rope_beta_fast"], prog["rope_beta_slow"],
            prog["rope_mscale"], prog["rope_mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
    assert conf["topk_method"] == "noaux_tc" and conf["norm_topk_prob"]
    # the published deployment's share: 256 experts over 32 chips
    assert pub["n_routed_experts"] // 32 == conf["n_routed_experts"]
    assert "rope_scaling" not in pub
    # the floors of a cut: a whole period and at least 4 layers after the
    # dense ones, at least 8 routed experts
    assert conf["num_hidden_layers"] - conf["first_k_dense_replace"] >= 4
    assert conf["n_routed_experts"] >= 8


TINY = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 16, "v_head_dim": 16, "kv_lora_rank": 32,
        "q_lora_rank": 32, "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "intermediate_size": 128, "moe_intermediate_size": 32,
        "n_shared_experts": 1, "n_routed_experts": 4, "vocab_size": 256,
        "published": {"n_routed_experts": 16}}


def _tiny():
    c = copy.deepcopy(_conf())
    c.update(copy.deepcopy(TINY))
    return c


def test_step_bytes_of_the_tiny_cut_by_hand():
    conf = _tiny()
    # attention: norm 64, wq_a 64x32, q_norm 32, wq_b 32 x 4*(16+16),
    # w_dkv 64 x (32+16), kv_norm 32, w_uk|w_uv 32 x 4*(16+16),
    # wo 4*16 x 64
    attn = 64 + 2048 + 32 + 4096 + 3072 + 32 + 4096 + 4096
    assert step_bytes.attn_params(conf) == attn == 17536
    # the dense layer's MLP: norm + 3 x 64x128; an expert layer's: norm,
    # the router over all 16 experts and its bias, the shared expert
    # 3 x 64x32 (its 4 held routed experts left out); final norm, head
    dense, moe = 64 + 3 * 64 * 128, 64 + 64 * 16 + 16 + 3 * 64 * 32
    weights = 3 * attn + dense + 2 * moe + 64 + 64 * 256
    assert step_bytes.step_weight_params(conf) == weights == 108192
    # a position's latent: 3 layers x (32 + 16) bf16 words
    assert step_bytes.cache_bytes_per_token(conf) == 288
    # feeding position 9 in 2 sequences: the weights, 2 embedding rows and
    # 2 contexts of 10 positions
    assert step_bytes.decode_step_bytes(conf, 2, 9) == \
        2 * weights + 2 * (2 * 64 + 288 * 10) == 222400


def test_step_bytes_at_the_served_widths():
    """~7.7 GB of weights a step (of 13.4 GB held: the routed experts
    left out), 9.2 kB of latent a position."""
    conf = _conf()
    w = step_bytes.ELEM * step_bytes.step_weight_params(conf)
    assert 7.6e9 < w < 7.8e9
    assert step_bytes.cache_bytes_per_token(conf) == 8 * 576 * 2
    v2 = registry.config(registry.benchmark(), "deepseek-v2-lite-16b")
    assert step_bytes.attn_params(v2) == 2048 + 2048 * 16 * 192 \
        + 2048 * 576 + 512 + 512 * 16 * 256 + 16 * 128 * 2048


def test_decode_hbm_roofline_reads_the_replays():
    ms = 1_000_000
    conf = _tiny()
    r = harness.RequestLog(0, 8, 3, 2, times=[10 * ms, 20 * ms, 30 * ms,
                                              2000 * ms])
    trace = devtrace.DeviceTrace(
        window_s=1.0, busy_s=0.5, replays=2, replay_kernel_s=4e-6,
        span_kernel_s={}, top_ops=[], idle_by_host=[], marker_offsets_ns=[],
        n_events=0)
    run = harness.Run(conf=conf, traffic={"page_tokens": 4},
                      window=(0, 1000 * ms), requests=[r], setup_s=1.0,
                      peak_bytes=0, spans={}, tier_bytes={}, trace=trace)
    # the two steps in the window feed positions 8 and 9
    least = (step_bytes.decode_step_bytes(conf, 2, 8)
             + step_bytes.decode_step_bytes(conf, 2, 9)) / counts.HBM_BYTES_S
    got = registry.metric_reader("decode_hbm_roofline").read(run)
    assert got == pytest.approx(100 * least / 4e-6)
    run.trace = None
    assert registry.metric_reader("decode_hbm_roofline").read(run) is None
