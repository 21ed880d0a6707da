"""Port vs reference: Mamba1 (falcon-mamba-7b) at ``smoke_config`` with
the reference's weights (``params_from_jax``), the depthwise causal conv
and softplus both Mamba mixers use, and serving of the two recurrent
models (falcon-mamba-7b, zamba2-7b) on a CPU tier.

Tolerances:
* ``causal_conv1d``: bit-equal to the reference's ``conv_general_dilated``,
  run op by op and jitted (K shifted products summed in f32 and rounded
  once, as XLA's grouped conv rounds);
* ``softplus``: the reference's ``logaddexp(x, 0)`` form, within 4 f32
  ulps of ``jax.nn.softplus`` over [-100, 100] and past its threshold;
* ``mamba1_mix`` against the reference run op by op under
  ``jax.disable_jit()``: the output within 2 bf16 ulps of its largest
  value, the f32 scan state within f32 tolerance (rtol 1e-5, atol 1e-6)
  and the conv state bit-equal; against the jitted reference (whose
  compiled graph keeps some bf16 products in f32): atol 0.0625 and RMS
  0.01, the bound of ``tests/test_torch_model.py``;
* falcon-mamba prefill and teacher-forced decode logits against the
  reference's jitted ``decode_step``, and the port's prefill into the
  cache against the reference's ``forward``: that bound again, greedy
  tokens within the margin-aware bound of ``tests/test_kv_dtype.py``;
* decode == forward within the port: the reference's own bound for it
  (``tests/test_arch_smoke.py``, rtol = atol = 0.15);
* serving: tokens of the scheduler and of each stream equal solo runs
  exactly, nothing paged, the tier empty, and the admission projection
  equal to the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.runtime import serving as rserving  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

ATOL, RMS = 0.0625, 0.01
B, PROMPT, STEPS, MAX_SEQ = 2, 40, 12, 64
NAME = "falcon-mamba-7b"
RECURRENT = ["falcon-mamba-7b", "zamba2-7b"]


@pytest.fixture(scope="module")
def pairs(smoke_model):
    cache = {}

    def get(name):
        if name not in cache:
            rcfg, rparams = smoke_model(name)
            tcfg = smoke_config(ARCHS[name])
            tree = jax.tree.map(np.asarray, rparams)
            cache[name] = (rcfg, rparams, tcfg,
                           tm.params_from_jax(tcfg, tree, device="cpu"))
        return cache[name]
    return get


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _tokens(cfg, n, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)


def _margin_bound(ref, got):
    """The margin-aware greedy bound of tests/test_kv_dtype.py."""
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    assert rms < 0.5 * float(np.median(margin)), (rms, np.median(margin))
    assert agree[margin > 4.0 * rms].all()
    assert agree.mean() > 0.8
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99


def _model_bound(ref, got):
    assert np.isfinite(got).all()
    diff = np.abs(ref - got)
    assert diff.max() <= ATOL, diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= RMS
    _margin_bound(ref, got)


def _ulps(want, got, n):
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=n * ulp)


# ---------------------------------------------------------------------------
# the conv and softplus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 16, 40])
def test_causal_conv1d_bit_equal_to_reference(S, with_state):
    rng = np.random.default_rng(S + 7 * with_state)
    C, K = 320, 4
    x = rng.standard_normal((B, S, C)) * 2
    w = rng.standard_normal((C, K)) * 0.7
    b = rng.standard_normal(C)
    s0 = rng.standard_normal((B, K - 1, C)) if with_state else None
    j = (lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16))
    with jax.disable_jit():
        want, wstate = rlayers.causal_conv1d(j(x), j(w), j(b), j(s0))
    jitted, _ = jax.jit(rlayers.causal_conv1d)(j(x), j(w), j(b), j(s0))
    got, state = tlayers.causal_conv1d(bf16(x), bf16(w), bf16(b),
                                       None if s0 is None else bf16(s0))
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, C)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jitted, np.float32))
    xin = np.concatenate([np.zeros((B, K - 1, C)) if s0 is None else s0,
                          x], axis=1)
    np.testing.assert_array_equal(state.float().numpy(),
                                  bf16(xin[:, -(K - 1):]).float().numpy())
    if wstate is not None:
        np.testing.assert_array_equal(state.float().numpy(),
                                      np.asarray(wstate, np.float32))


def test_softplus_is_the_references_logaddexp_form():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-100, 100, 20001), [19.5, 20.0, 20.5,
                                                        25.0, 88.0],
                        rng.standard_normal(20000) * 5]).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tlayers.softplus(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)))
    assert (np.abs(got - want) <= 4 * ulp).all()
    # F.softplus turns into the identity past its threshold of 20; the
    # logaddexp form adds log1p(exp(-x)), below an ulp of x there
    big = torch.tensor([25.0, 40.0])
    assert torch.equal(tlayers.softplus(big), big)


# ---------------------------------------------------------------------------
# the Mamba1 mixer
# ---------------------------------------------------------------------------

def _states(rng, rcfg):
    """A random incoming state of one layer: conv in bf16, ssm f32."""
    jc = jinit_cache(rcfg, B, MAX_SEQ)["layers"]
    out = {}
    for kind, leaf in jc.items():
        a = rng.standard_normal(leaf.shape[1:]) * 0.5
        out[kind] = a.astype(np.float32)
    return out


def check_mix(pair, mix: str, S: int, with_state: bool):
    """The port's mixer against the reference's, op by op and jitted,
    from a random incoming state (or none)."""
    rcfg, rparams, tcfg, tparams = pair
    rp = jax.tree.map(lambda a: a[0], rparams["layers"])
    tp = tm._layer(tparams["layers"], 0)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    st = _states(rng, rcfg) if with_state else None
    jst = None if st is None else {
        "conv": jnp.asarray(st["conv"], jnp.bfloat16),
        "ssm": jnp.asarray(st["ssm"], jnp.float32)}
    xj = jnp.asarray(x, jnp.bfloat16)
    fn = getattr(rlayers, mix)
    with jax.disable_jit():
        want, wst = fn(xj, rp, rcfg, state=jst)
    jitted, _ = jax.jit(lambda x, p, s: fn(x, p, rcfg, state=s))(xj, rp, jst)
    tst = None if st is None else {"conv": bf16(st["conv"]),
                                   "ssm": torch.from_numpy(st["ssm"])}
    got = getattr(tlayers, mix)(bf16(x), tp, tcfg, state=tst)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, tcfg.d_model)
    want, jitted = np.asarray(want, np.float32), np.asarray(jitted, np.float32)
    got = got.float().numpy()
    _ulps(want, got, 2)
    diff = np.abs(got - jitted)
    assert diff.max() <= ATOL and np.sqrt(np.mean(diff ** 2)) <= RMS
    if tst is not None:
        assert tst["ssm"].dtype == torch.float32
        np.testing.assert_allclose(tst["ssm"].numpy(),
                                   np.asarray(wst["ssm"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(tst["conv"].float().numpy(),
                                      np.asarray(wst["conv"], np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 16, 40])
def test_mamba1_mix_matches_reference(pairs, S, with_state):
    check_mix(pairs(NAME), "mamba1_mix", S, with_state)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def port_trajectory(cfg, params, toks, spans, max_seq):
    """Teacher-forced logits (B, len(spans), vocab) of the spans' last
    positions from the port's ``decode_step`` over one cache."""
    tc = tm.init_cache(cfg, B, max_seq, device="cpu")
    out = []
    for lo, hi in spans:
        lt, tc = tm.decode_step(cfg, params, {
            "tokens": torch.from_numpy(toks[:, lo:hi]), "cache_pos": lo}, tc)
        out.append(lt[:, -1].float().numpy())
    return np.stack(out, 1)


def trajectories(pair, spans):
    """The same from the reference's jitted ``decode_step`` and the
    port's: ``(ref, got)``."""
    rcfg, rparams, tcfg, tparams = pair
    T = spans[-1][1]
    toks = _tokens(tcfg, T)
    step = jax.jit(jdecode, static_argnums=0)
    jc = jinit_cache(rcfg, B, max(MAX_SEQ, T))
    js = []
    for lo, hi in spans:
        lj, jc = step(rcfg, rparams, {"tokens": jnp.asarray(toks[:, lo:hi]),
                                      "cache_pos": jnp.int32(lo)}, jc)
        js.append(np.asarray(lj[:, -1], np.float32))
    return np.stack(js, 1), port_trajectory(tcfg, tparams, toks, spans,
                                            max(MAX_SEQ, T))


PROMPT_SPANS = [(0, PROMPT)] + [(PROMPT + t, PROMPT + t + 1)
                                for t in range(STEPS)]


def test_falcon_prefill_and_decode_logits_match_reference(pairs):
    ref, got = trajectories(pairs(NAME), PROMPT_SPANS)
    _model_bound(ref, got)


def test_falcon_prefill_into_cache_matches_reference_forward(pairs):
    rcfg, rparams, tcfg, tparams = pairs(NAME)
    toks = _tokens(tcfg, PROMPT, seed=4)
    want, _, _ = jax.jit(lambda p, b: jforward(rcfg, p, b))(
        rparams, {"tokens": jnp.asarray(toks)})
    cache = tm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    got, cache = tm.decode_step(tcfg, tparams, {
        "tokens": torch.from_numpy(toks), "cache_pos": 0}, cache)
    _model_bound(np.asarray(want, np.float32), got.float().numpy())
    fwd, _ = tm.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(fwd, got)       # a zero state is the forward's padding
    assert cache["layers"]["ssm"].abs().amax() > 0


def test_falcon_decode_matches_forward(pairs):
    _, _, cfg, params = pairs(NAME)
    S = 32
    toks = torch.from_numpy(_tokens(cfg, S, seed=3))
    full, none = tm.forward(cfg, params, {"tokens": toks})
    assert none is None
    cache = tm.init_cache(cfg, B, S, device="cpu")
    steps = []
    for t in range(S):
        lt, cache = tm.decode_step(cfg, params, {
            "tokens": toks[:, t:t + 1], "cache_pos": t}, cache)
        steps.append(lt[:, 0].float().numpy())
    np.testing.assert_allclose(np.stack(steps, 1), full.float().numpy(),
                               rtol=0.15, atol=0.15)


def test_fp8_cache_keeps_the_state_f32(pairs):
    """An fp8 ``kv_dtype`` stores the conv inputs in fp8; the scan state
    stays f32, and the greedy tokens track the bf16 cache's.  (The
    reference's fp8 SSM cache cannot run a step: concatenating the fp8
    conv state with bf16 inputs raises ``TypePromotionError``.)"""
    pair = pairs(NAME)
    cfg8 = dataclasses.replace(pair[2], kv_dtype="float8_e4m3fn")
    cache = tm.init_cache(cfg8, B, MAX_SEQ, device="cpu")
    assert cache["layers"]["conv"].dtype == torch.float8_e4m3fn
    assert cache["layers"]["ssm"].dtype == torch.float32
    toks = _tokens(cfg8, PROMPT + STEPS)
    got16 = port_trajectory(pair[2], pair[3], toks, PROMPT_SPANS, MAX_SEQ)
    got8 = port_trajectory(cfg8, pair[3], toks, PROMPT_SPANS, MAX_SEQ)
    _margin_bound(got16, got8)


def test_ssm_init_kinds_are_the_references():
    """``A_log`` is exactly log 1..N (f32), Mamba2's ``A_log`` the log of
    a uniform draw in [1, 16) a head, ``dt_bias`` softplus^-1 of a dt in
    [1e-3, 0.1) (f32), ``D`` ones (bf16); seeded draws repeat."""
    m1 = smoke_config(ARCHS[NAME])
    a = tm.init_params(m1, seed=5, device="cpu")["layers"]
    b = tm.init_params(m1, seed=5, device="cpu")["layers"]
    assert a["A_log"].dtype == a["dt_bias"].dtype == torch.float32
    logs = np.log(np.arange(1, m1.ssm_state + 1, dtype=np.float32))
    np.testing.assert_allclose(a["A_log"].numpy(),
                               np.broadcast_to(logs, a["A_log"].shape),
                               rtol=1e-7, atol=0)
    assert torch.equal(a["dt_bias"], b["dt_bias"])
    dt = tlayers.softplus(a["dt_bias"]).numpy()
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt < 0.1 * (1 + 1e-5)).all()
    assert a["D"].dtype == torch.bfloat16 and bool((a["D"] == 1).all())
    m2 = smoke_config(ARCHS["zamba2-7b"])
    p2 = tm.init_params(m2, seed=5, device="cpu")
    a2 = torch.exp(p2["layers"]["A_log"])
    assert p2["layers"]["A_log"].dtype == torch.float32
    assert bool((a2 >= 1).all() and (a2 < 16 * (1 + 1e-6)).all())
    assert p2["shared"]["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# serving the recurrent models
# ---------------------------------------------------------------------------

ENGINE = dict(page_tokens=16, hbm_kv_budget=1 << 12, device="cpu")


def _solo(cfg, params, max_seq, prompt, n, seed=0):
    return tserving.ServeEngine(
        cfg, params, max_seq=max_seq, batch=1, device_kind="trace",
        policy=tpaging.PAPER_POLICY, **ENGINE).generate(prompt, n, seed=seed)


def _tier_empty(tier):
    for dev in getattr(tier, "shards", [tier]):
        assert dev.stats.dram_bytes_stored == dev.stats.raw_bytes_stored == 0
        assert dev.stats.blocks == 0 and not dev._tensors


@pytest.mark.parametrize("name", RECURRENT)
def test_engine_pages_nothing_and_decodes_greedily(pairs, name):
    """A ServeEngine commits no page (no k / v / c_kv in the cache), the
    tier stays empty, and its tokens are a greedy decode through
    ``decode_step``."""
    _, _, cfg, params = pairs(name)
    prompt = _tokens(cfg, 40, seed=9)[:1]
    eng = tserving.ServeEngine(cfg, params, max_seq=96, batch=1,
                               device_kind="trace",
                               policy=tpaging.PAPER_POLICY, **ENGINE)
    toks = eng.generate(prompt, 6)
    s = eng.stats()
    assert s.spilled_pages == s.hbm_page_bytes == s.kv_logical_bytes == 0
    assert not list(eng.pool.iter_pages())
    assert not eng._attention_masses()
    _tier_empty(eng.pool.tier)
    cache = tm.init_cache(cfg, 1, 96, device="cpu")
    logits, cache = tm.decode_step(cfg, params, {
        "tokens": torch.from_numpy(prompt), "cache_pos": 0}, cache)
    want = []
    for t in range(6):
        nxt = int(logits[0, -1].float().argmax())
        want.append(nxt)
        logits, cache = tm.decode_step(cfg, params, {
            "tokens": torch.tensor([[nxt]]), "cache_pos": 40 + t}, cache)
    np.testing.assert_array_equal(toks[0], want)
    assert eng.retire() == 0


@pytest.mark.parametrize("name", RECURRENT)
def test_scheduler_and_streams_equal_solo_runs(pairs, name):
    _, _, cfg, params = pairs(name)
    rng = np.random.default_rng(2)
    reqs = [tserving.ServeRequest(
        req_id=i, arrival=float(a),
        prompt=rng.integers(0, cfg.vocab, (1, 24)).astype(np.int32),
        max_new_tokens=4, seed=50 + i) for i, a in enumerate([0, 0, 1.5])]
    sched = tserving.ServeScheduler(cfg, params, max_batch=2,
                                    device_kind="trace",
                                    policy=tpaging.PAPER_POLICY,
                                    kv_capacity_bytes=1, **ENGINE)
    rep = sched.run(reqs)
    assert len(rep.records) == 3 and rep.peak_active == 2
    for req, rec in zip(reqs, rep.records):
        assert rec.kv_projected_bytes == rec.kv_charged_bytes == 0
        np.testing.assert_array_equal(
            rec.tokens, _solo(cfg, params, sched.max_seq, req.prompt, 4,
                              seed=req.seed))
    _tier_empty(sched.tier)
    prompts = [rng.integers(0, cfg.vocab, (1, 24)).astype(np.int32)
               for _ in range(2)]
    multi = tserving.MultiStreamEngine(cfg, params, 2, max_seq=64, batch=1,
                                       device_kind="trace",
                                       policy=tpaging.PAPER_POLICY, **ENGINE)
    toks = multi.generate(prompts, 4)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(toks[i], _solo(cfg, params, 64, p, 4,
                                                     seed=i))
    assert multi.retire() == 0
    _tier_empty(multi.tier)


@pytest.fixture
def ref_slope_cache():
    """Leave the reference's process-wide ``_kv_bytes_per_token_b1``
    cache (``lru_cache(maxsize=32)``) as empty as this test found it in a
    fresh process: ``tests/test_prefix_share.py`` bounds its size, and
    xdist may run that file after this one in the same worker."""
    yield
    rserving._kv_bytes_per_token_b1.cache_clear()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_admission_projection_matches_reference(name, kv_dtype,
                                               ref_slope_cache):
    """The paged-KV bytes a token adds, from the cache's shapes at full
    width (nothing allocated), equal the reference's for every arch: 0
    for the recurrent models, whose state pages nothing."""
    tcfg = dataclasses.replace(ARCHS[name], kv_dtype=kv_dtype)
    rcfg = dataclasses.replace(RARCHS[name], kv_dtype=kv_dtype)
    got = tserving._kv_bytes_per_token_b1(tcfg)
    assert got == rserving._kv_bytes_per_token_b1(rcfg)
    assert tserving.projected_kv_bytes(tcfg, 2, 576, 64) == \
        rserving.projected_kv_bytes(rcfg, 2, 576, 64)
    assert (got == 0) == (name in RECURRENT)
