"""The benchmark's plain reference held to the port at a size the CPU
holds: the decoders' forward (float32 weights on both sides, so that only
the order of sums differs), the precision views on every BF16 pattern,
and, through the harness, the spill schedule and the served logits."""

import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch = pytest.importorskip("torch")

from portbench import check, harness, registry, weights  # noqa: E402
from portbench.reference import policy, views  # noqa: E402
from portbench.tests import tiny  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_forward_matches_the_port_in_float32(model):
    from repro_torch.models.model import forward

    cell = tiny.cell(model)
    cfg = cell.program_config()
    params = _f32(weights.make(cfg, 3, torch.device("cpu")))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 48)))
    with torch.no_grad():
        want = forward(cfg, params, {"tokens": tokens})[0].float()
    got = registry.reference(cell.conf["model_type"]).forward(
        cell.conf, params, tokens, prompt_len=48, out_positions=range(48))
    err = (got - want).abs().max().item()
    assert err <= 2e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("name", list(views.VIEWS))
def test_views_match_the_port_on_every_pattern(name):
    from repro_torch.core.precision import VIEWS, truncate_reference

    words = np.arange(1 << 16, dtype=np.uint16)
    want = truncate_reference(words, VIEWS[name]).astype(np.int32)
    got = views.view_words(torch.from_numpy(words.astype(np.int32)), name)
    assert np.array_equal(got.numpy(), want)


def test_views_round_trip_values():
    x = torch.tensor([1.0, 1.5, 1.75, -3.0, 0.0])
    assert torch.equal(views.view_values(x, "bf16"), x)
    # man0 keeps sign and exponent; a set guard bit is a tie, which rounds
    # to the even exponent
    got = views.view_values(torch.tensor([1.25, 1.5, 3.0, -1.5]), "man0")
    assert got.tolist() == [1.0, 2.0, 2.0, -2.0]


def test_schedule_spills_oldest_and_ranks_newest_first():
    pb = {"k": 10, "v": 10}
    s = policy.schedule(layers=2, kinds=("k", "v"), page_bytes=pb,
                        page_tokens=4, budget=40, prompt_len=12, steps=4,
                        tiers=[(2, "bf16"), (1, "man4")], tail="man0")
    # 3 windows x 4 pages committed at the prefill, 4 fit: 8 spill, oldest
    # first; the newest spilled take the top tiers
    first = {k: v for k, v in s.items() if v.issued == 0}
    assert sorted(k[2] for k in first) == [0] * 4 + [4] * 4
    assert [first[(0, "k", 4)].view, first[(1, "k", 4)].view,
            first[(0, "v", 4)].view, first[(0, "k", 0)].view] == \
        ["bf16", "bf16", "man4", "man0"]
    # the window completed by decode step 4 spills the next oldest
    assert {k for k, v in s.items() if v.issued == 4} == \
        {(0, "k", 8), (1, "k", 8), (0, "v", 8), (1, "v", 8)}
    assert all(v.visible == v.issued + 2 for v in s.values())


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_served_run_is_correct_against_the_reference(model):
    cell = tiny.cell(model)
    run, srv = harness.run(cell, 2147483659, 1.0, False,
                           torch.device("cpu"), time.perf_counter_ns())
    params = srv.params
    srv.close()
    assert any(r.pages_spilled for r in run.requests)
    ok, checks = check.check(cell, run, params, 2147483659)
    assert ok, checks
    values = {n: v for n, v, _ in checks}
    assert values["tier_pages_off"] == 0 and values["tier_words_off"] == 0


def test_yarn_at_the_served_factor_is_the_plain_rotary_embedding():
    from portbench.reference import deepseek_v2

    conf = registry.config(registry.benchmark(), tiny.DEEPSEEK)
    assert conf["rope_scaling"]["mscale_all_dim"] == 0.707
    assert deepseek_v2.yarn(conf) == (None, 1.0, 1.0)
    published = dict(conf, rope_scaling=conf["published"]["rope_scaling"])
    freqs, gain, soft = deepseek_v2.yarn(published)
    plain = 1e4 ** (-torch.arange(32, dtype=torch.float64) / 32)
    assert gain == 1.0
    assert soft == pytest.approx((0.1 * 0.707 * np.log(40) + 1) ** 2)
    assert torch.equal(freqs[:10], plain[:10])
    assert torch.allclose(freqs[-7:], plain[-7:] / 40)
