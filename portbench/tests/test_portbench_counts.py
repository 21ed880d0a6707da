"""The frozen count functions against hand-worked small shapes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import counts  # noqa: E402

DENSE = {"hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "num_hidden_layers": 3,
         "intermediate_size": 16, "vocab_size": 10}
MOE = {"hidden_size": 8, "num_attention_heads": 2, "num_hidden_layers": 3,
       "intermediate_size": 16, "vocab_size": 10, "kv_lora_rank": 4,
       "qk_nope_head_dim": 3, "qk_rope_head_dim": 2, "v_head_dim": 5,
       "first_k_dense_replace": 1, "n_routed_experts": 16,
       "num_experts_per_tok": 2, "n_shared_experts": 1,
       "moe_intermediate_size": 6}


def test_dense_token():
    # a layer: q 8x8, o 8x8, k and v 8x4 each, MLP 3 x 8x16 = 576 weights
    # attention over 5 positions: 2 heads x 5 x (4 + 4) products, x2 ops
    assert counts.token_flops(DENSE, 5, False) == 2 * 3 * 576 + 2 * 3 * 2 * 5 * 8
    assert counts.token_flops(DENSE, 5, True) == \
        counts.token_flops(DENSE, 5, False) + 2 * 8 * 10


def test_moe_token_counts_routed_experts_at_top_k():
    # MLA: q 8 x 2*(3+2) = 80, down 8 x (4+2) = 48, up 4 x 2*(3+5) = 64,
    # o 2*5 x 8 = 80: 272; the dense layer's MLP 384; an expert layer's
    # router 8 x 16 = 128 and (2 routed + 1 shared) x 3 x 8 x 6 = 432
    dense, moe = 272 + 384, 272 + 128 + 432
    attn = 2 * 3 * 2 * 7 * (5 + 5)
    assert counts.token_flops(MOE, 7, False) == 2 * (dense + 2 * moe) + attn
    more_experts = dict(MOE, n_routed_experts=64)
    assert counts.token_flops(more_experts, 7, False) - \
        counts.token_flops(MOE, 7, False) == 2 * 2 * 8 * 48
    more_k = dict(MOE, num_experts_per_tok=3)
    assert counts.token_flops(more_k, 7, False) - \
        counts.token_flops(MOE, 7, False) == 2 * 2 * 3 * 8 * 6


def test_prefill_is_its_tokens_with_one_head():
    P = 6
    want = sum(counts.token_flops(DENSE, t + 1, False) for t in range(P)) \
        + 2 * 8 * 10
    assert counts.prefill_flops(DENSE, 3, P) == pytest.approx(3 * want)
    assert counts.decode_flops(DENSE, 3, P) == \
        3 * counts.token_flops(DENSE, P + 1, True)


def test_tier_and_bounds():
    assert counts.tier_least_s(counts.tier_write_bytes(100, 60),
                               counts.tier_read_bytes(60, 100)) == \
        pytest.approx(320 / counts.HBM_BYTES_S)
    assert counts.bound_ms(3.35e9, 0)[0] == pytest.approx(1.0)
    ms, by = counts.attn_bound(1024, 14, 2, 64)
    assert by == "bytes" and ms == pytest.approx(
        (2 * 1024 * 2 * 64 * 2 + 14 * 64 * 6) / counts.HBM_BYTES_S * 1e3)
    now, before = counts.match_bytes([0, 100], [100, 110], 5, 1)
    assert now == 110 + 88 + 16 + 60
    assert before == 8 * 97 + 72 + 60
