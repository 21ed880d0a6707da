"""DeepSeek-V3 in the port at a size the CPU holds, held to the
benchmark's plain float32 reference (``portbench/reference/deepseek_v3.py``):
the query LoRA, YaRN, sigmoid group-limited routing over the router's
experts and the expert share this chip holds of them.

The tiny cut: d 64, 4 heads (qk 16 + 16 rope, v 16), q_lora 32, kv_lora
32, 3 layers (1 dense), 16 routed experts in 4 groups (top 2 groups, top
4 experts, scale 2.5), 1 shared expert, YaRN at factor 40 on 4096
original positions; the configuration file's published keys otherwise.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import registry, weights  # noqa: E402
from portbench.reference import deepseek_v2, deepseek_v3  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.tier import make_device  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import ServeEngine  # noqa: E402

MODEL = "deepseek-v3-671b"
E_ALL = 16

_HF = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
       "num_key_value_heads": 4, "num_hidden_layers": 3,
       "first_k_dense_replace": 1, "vocab_size": 256, "q_lora_rank": 32,
       "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
       "v_head_dim": 16, "n_group": 4, "topk_group": 2,
       "num_experts_per_tok": 4, "moe_intermediate_size": 32}
_PROG = {"d_model": 64, "d_ff": 128, "n_heads": 4, "n_kv_heads": 4,
         "head_dim": 16, "n_layers": 3, "first_dense": 1, "vocab": 256,
         "q_lora_rank": 32, "kv_lora_rank": 32, "qk_rope_dim": 16,
         "v_head_dim": 16, "n_group": 4, "topk_group": 2, "top_k": 4,
         "moe_d_ff": 32, "router_experts": E_ALL}


def tiny_conf(held: int = 4, offset: int = 4, capacity: float = 1.25):
    """The configuration file cut to the tiny size, holding ``held`` of
    the router's 16 experts from ``offset``."""
    c = copy.deepcopy(registry.config(registry.benchmark(), MODEL))
    c.update(_HF, n_routed_experts=held, expert_offset=offset,
             capacity_factor=capacity)
    c["published"]["n_routed_experts"] = E_ALL
    c["program"].update(_PROG, n_experts=held, expert_offset=offset,
                        capacity_factor=capacity)
    return c


def program(conf) -> ArchConfig:
    return ArchConfig(**conf["program"])


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_forward_matches_the_reference_in_float32():
    """Float32 weights on both sides, so only the order of sums differs:
    2e-4 of the largest logit, as the other decoders' reference test
    (an expert chosen otherwise would move the logits by far more)."""
    conf = tiny_conf()
    cfg = program(conf)
    params = _f32(weights.make(cfg, 3, torch.device("cpu")))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 48)))
    with torch.no_grad():
        want = tm.forward(cfg, params, {"tokens": tokens})[0].float()
    got = deepseek_v3.forward(conf, params, tokens, prompt_len=48,
                              out_positions=range(48))
    err = (got - want).abs().max().item()
    assert err <= 2e-4 * want.abs().max().item(), err


def _served_logits(cfg, params, prompt, n_steps):
    """The engine's prefill, then greedy decode steps through its cache:
    the logits at each served position (B, n_steps + 1, vocab) and the
    tokens fed."""
    eng = ServeEngine(cfg, params, max_seq=prompt.shape[1] + n_steps + 16,
                      batch=prompt.shape[0], page_tokens=16,
                      hbm_kv_budget=1 << 30,
                      device_kind=make_device("trace", device="cpu"),
                      device="cpu")
    logits = [eng.prefill(prompt)]
    fed = []
    for _ in range(n_steps):
        nxt = logits[-1].argmax(-1).astype(np.int32)
        fed.append(nxt)
        logits.append(eng.decode(nxt.reshape(-1, 1)))
    eng.retire()
    return np.stack(logits, 1), np.stack(fed, 1)


def test_served_prefill_and_cached_decode_match_the_full_forward():
    """The engine's bf16 prefill and decode steps through the latent
    cache against the reference's full float32 forward over the prompt
    and the tokens fed, by logits: at each served position the largest
    difference over the vocabulary, as a share of the largest logit.
    Their median is at most 0.05: bf16's rounding of weights and
    activations reads 0.015-0.017 on seeds 1-4, and the reference
    computed in float8 (the control, one precision below the served
    bf16) 0.20-0.27.  The median and not the largest: a router near-tie
    that bf16 settles otherwise than float32 moves one position's logits
    by up to 0.4 (seeds 2 and 4), and the control's worst positions read
    no more than that.  The prefill's own position, which the cache does
    not serve, is held to 0.1 (0.014-0.075)."""
    conf = tiny_conf()
    cfg = program(conf)
    P, N = 40, 12
    for seed in (1, 2):
        params = weights.make(cfg, seed, torch.device("cpu"))
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab, (2, P)).astype(np.int32)
        got, fed = _served_logits(cfg, params, prompt, N)
        tokens = torch.from_numpy(np.concatenate(
            [prompt, fed], 1).astype(np.int64))
        kw = dict(prompt_len=P, out_positions=range(P - 1, P + N))
        want = deepseek_v3.forward(conf, params, tokens, **kw).numpy()
        ctl = deepseek_v3.forward(conf, params, tokens, numerics="fp8",
                                  **kw).numpy()
        scale = np.abs(want).max()
        err = np.abs(got - want).max(-1) / scale
        assert np.median(err) <= 0.05 and err[:, 0].max() <= 0.1, (seed, err)
        assert np.median(np.abs(ctl - want).max(-1) / scale) > 0.1


@pytest.mark.parametrize("capacity", [1.0, 4.0])
def test_expert_shares_add_up_to_the_uncut_layer(capacity):
    """Four chips' shares of 4 of the 16 experts: each computes its
    experts' part of a prompt (under the uncut layer's capacity, which
    drops tokens at factor 1.0) and of a decode step's tokens; their
    parts, with the shared expert counted once, add up to the uncut
    reference layer (float32 weights: the order of sums alone
    differs)."""
    uncut = tiny_conf(held=E_ALL, offset=0, capacity=capacity)
    params = _f32(weights.make(program(uncut), 5, torch.device("cpu")))
    moe = tm._layer(params["layers"]["moe"], 0)
    x = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(0))
    stacked = {k: (v[None] if not isinstance(v, dict) else
                   {kk: vv[None] for kk, vv in v.items()})
               for k, v in moe.items()}
    for S in (24, 1):
        xs = x[:, :S]
        want = deepseek_v3._moe(xs, stacked, 0, uncut, S if S > 1 else 0,
                                deepseek_v3.Numerics("f32"))
        h = L.norm(xs, moe["norm"], "rmsnorm")
        shared = L.mlp_apply(h, moe["shared"], "swiglu")
        total = shared.clone()
        for off in range(0, E_ALL, 4):
            cfg = program(tiny_conf(held=4, offset=off, capacity=capacity))
            p = dict(moe, **{n: moe[n][off:off + 4]
                             for n in ("w1", "w2", "w3")})
            with torch.no_grad():
                out, _ = L.moe_block(xs, p, cfg)
            total += out - shared
        err = (total - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (S, err)


def _route_loop(flat, router, bias, G, top_groups, k, scale):
    """Group-limited routing one token at a time, in plain Python over
    the f32 scores (ties to the lower index)."""
    scores = torch.sigmoid(flat.float() @ router.float())
    biased = (scores + bias.float()).tolist()
    scores = scores.tolist()
    E = router.shape[-1]
    per = E // G
    gates, experts = [], []
    for t in range(flat.shape[0]):
        b = biased[t]
        group = [sum(sorted(b[g * per:(g + 1) * per], reverse=True)[:2])
                 for g in range(G)]
        kept = sorted(range(G), key=lambda g: (-group[g], g))[:top_groups]
        allowed = [e for e in range(E) if e // per in kept]
        chosen = sorted(allowed, key=lambda e: (-b[e], e))[:k]
        w = [scores[t][e] for e in chosen]
        gates.append([v / (sum(w) + 1e-20) * scale for v in w])
        experts.append(chosen)
    return torch.tensor(gates), torch.tensor(experts)


def test_grouped_routing_matches_a_per_token_loop():
    """Experts exactly, gates to f32 rounding; ties included: groups 0
    and 2 are copies of each other (tied group scores and tied experts
    across them) and experts 4 and 5 of one another."""
    cfg = program(tiny_conf())
    g = torch.Generator().manual_seed(4)
    flat = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    router = torch.randn(64, E_ALL, generator=g).div(8).to(torch.bfloat16)
    bias = torch.randn(E_ALL, generator=g).div(10).to(torch.bfloat16)
    router[:, 8:12] = router[:, 0:4]
    bias[8:12] = bias[0:4]
    router[:, 5] = router[:, 4]
    bias[5] = bias[4]
    gates, experts = L.route_grouped(flat, router, bias, cfg)
    want_g, want_e = _route_loop(flat, router, bias, 4, 2, 4, 2.5)
    assert torch.equal(experts, want_e)
    assert torch.allclose(gates, want_g, rtol=4e-7, atol=0)
    ref_g, ref_e = deepseek_v3.route(flat.float(), router.float(),
                                     bias.float(), tiny_conf())
    assert torch.equal(ref_e, want_e)
    assert torch.allclose(ref_g, want_g, rtol=4e-7, atol=0)
    # the ties were there to break: both copies of the tied experts among
    # some token's candidates, and the lower index chosen first
    both = ((experts == 4).any(1) & (experts == 5).any(1))
    assert both.any()
    pos4 = (experts == 4).float().argmax(1)
    pos5 = (experts == 5).float().argmax(1)
    assert (pos4[both] < pos5[both]).all()


@pytest.mark.parametrize("conf", [
    lambda: registry.config(registry.benchmark(), MODEL), tiny_conf])
def test_yarn_matches_the_reference(conf):
    """The port's f32 YaRN frequencies, computed as the published code
    does, against the reference's float64 ones (``deepseek_v2.yarn``):
    equal to f32 rounding; the gains equal."""
    c = conf()
    cfg = program(c)
    freqs, gain, soft = L.yarn(cfg, cfg.qk_rope_dim, torch.device("cpu"))
    want_f, want_gain, want_soft = deepseek_v2.yarn(c)
    assert freqs.dtype == torch.float32
    assert torch.allclose(freqs.double(), want_f, rtol=3e-7, atol=0)
    assert gain == want_gain == 1.0
    assert soft == pytest.approx(want_soft, rel=1e-15)
    assert soft == pytest.approx((0.1 * np.log(40) + 1) ** 2)
    # the blend: the fastest dimensions keep theta's frequencies, the
    # slowest take them over the factor
    plain = 1e4 ** (-torch.arange(cfg.qk_rope_dim // 2,
                                  dtype=torch.float64)
                    / (cfg.qk_rope_dim // 2))
    assert torch.allclose(want_f[:2], plain[:2])
    assert torch.allclose(want_f[-1:], plain[-1:] / 40)


def test_plain_rotary_at_factor_one():
    cfg = dataclasses.replace(program(tiny_conf()), rope_factor=1.0)
    assert L.yarn(cfg, 16, torch.device("cpu")) == (None, 1.0, 1.0)


def test_a_share_on_the_mesh_path_is_refused():
    cfg = program(tiny_conf())
    with pytest.raises(ValueError, match="expert share"):
        L.moe_block_ep(torch.zeros(1, 4, 64), {}, cfg, None, None)


def test_config_checks_the_share():
    prog = dict(tiny_conf()["program"], expert_offset=14)
    with pytest.raises(ValueError, match="not all among"):
        ArchConfig(**prog)
    with pytest.raises(ValueError, match="scoring"):
        ArchConfig(**dict(prog, expert_offset=0, scoring="softplus"))


def _ops_of(fn):
    """The aten ops ``fn`` dispatches, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return ops


def test_spans_and_counters_record_a_served_request():
    """Under ``spans.record()`` a prefill opens ``mla.q_lora`` in every
    layer and ``moe.route`` and ``moe.held`` (the held experts' weight
    bytes) in every expert layer, under the request; its pair counters
    reach the recorder and ``ServeStats`` at the retire: routed = held +
    elsewhere, dropped at most held.  A decode step opens none and adds
    no op; off, nothing is recorded or counted."""
    conf = tiny_conf(capacity=1.0)
    cfg = program(conf)
    params = weights.make(cfg, 7, torch.device("cpu"))
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (2, 32))

    def engine():
        return ServeEngine(cfg, params, max_seq=64, batch=2, page_tokens=16,
                           hbm_kv_budget=1 << 30, key_prefix="r3.",
                           device_kind=make_device("trace", device="cpu"),
                           device="cpu")

    def decode_ops(eng):
        tok = torch.zeros(2, 1, dtype=torch.int64)
        pos = torch.tensor(eng.pos, dtype=torch.int32)
        cache = {k: {kk: vv.clone() for kk, vv in v.items()}
                 for k, v in eng.cache.items()}
        return _ops_of(lambda: tm.decode_step(
            cfg, params, {"tokens": tok, "cache_pos": pos}, cache))

    eng = engine()
    with spans.record() as rec:
        eng.prefill(prompt)
        n_prefill = len(rec.spans)
        ops_on = decode_ops(eng)
        eng.decode(np.zeros((2, 1), np.int32))
        decode_names = {s.name for s in rec.spans[n_prefill:]}
        eng.retire()
    stats = eng.stats()
    names = [s.name for s in rec.spans]
    n_moe = cfg.n_layers - cfg.first_dense
    assert names.count("mla.q_lora") == cfg.n_layers
    assert names.count("moe.route") == names.count("moe.held") == n_moe
    assert not decode_names & {"mla.q_lora", "moe.route", "moe.held"}
    held = [s for s in rec.spans if s.name == "moe.held"]
    w = tm._layer(params["layers"]["moe"], 0)
    assert all(s.nbytes == sum(w[n].nbytes for n in ("w1", "w2", "w3"))
               for s in held)
    assert all(s.request == "r3" for s in rec.spans
               if s.name.startswith(("moe.", "mla.")))
    c = rec.counters
    assert c["moe.routed_pairs"] == n_moe * 2 * 32 * cfg.top_k
    assert 0 < c["moe.held_pairs"] < c["moe.routed_pairs"]
    assert 0 < c["moe.dropped_pairs"] <= c["moe.held_pairs"]
    assert (stats.moe_routed_pairs, stats.moe_held_pairs,
            stats.moe_dropped_pairs) == (c["moe.routed_pairs"],
                                         c["moe.held_pairs"],
                                         c["moe.dropped_pairs"])
    off = engine()
    off.prefill(prompt)
    assert decode_ops(off) == ops_on
    off.decode(np.zeros((2, 1), np.int32))
    off.retire()
    s = off.stats()
    assert (s.moe_routed_pairs, s.moe_held_pairs, s.moe_dropped_pairs) == \
        (0, 0, 0)
