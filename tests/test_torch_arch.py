"""Port vs reference: every architecture of the reference, at
``smoke_config`` with the reference's weights (``params_from_jax``) —
the token decoders deepseek-v2-lite-16b (MLA, MoE with a shared expert,
a dense first layer), stablelm-12b (layernorm), qwen1.5-32b (QKV bias),
grok-1-314b (MoE, GELU, no shared experts) and nemotron-4-340b (squared
ReLU); the encoder-only hubert-xlarge and the embeds-fed llava-next-34b;
and every arch's parameter tree and cache layout, dtypes included
(falcon-mamba-7b and zamba2-7b are held to the reference's numbers in
``tests/test_torch_ssm.py`` and ``tests/test_torch_hybrid.py``).

Tolerances:
* prefill and teacher-forced decode logits against the reference's
  jitted ``decode_step``: atol 0.0625 and RMS 0.01 (the bound of
  ``tests/test_torch_model.py``), greedy tokens within the margin-aware
  bound of ``tests/test_kv_dtype.py``;
* decode == forward within the port: the reference's own bound for it
  (``tests/test_arch_smoke.py``, rtol = atol = 0.15);
* the fp8 cache of deepseek against its bf16 cache and against the
  reference's fp8 cache: the margin-aware bound of
  ``tests/test_kv_dtype.py::test_fp8_cache_decode_tracks_bf16`` (a bf16
  ulp apart before the cast can be an fp8 step apart after it);
* the MLA block: its output within 2 bf16 ulps of its largest value, the
  written ``c_kv`` / ``k_rope`` bit-equal;
* hubert's forward and llava's forward and teacher-forced decode from
  embeds against the reference's jitted ``forward`` / ``decode_step``:
  atol 0.0625 and RMS 0.01; llava's decode == forward within the port:
  rtol = atol = 0.15.

The reference's compiled CPU graph keeps some bf16 products in f32 (XLA
drops bf16 round trips), so its router logits are not always the bf16
values its source names; the model-level tests hold the logits to the
bounds above, and ``tests/test_torch_moe.py`` holds routing exactly
against the reference run op by op.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.models import abstract_params as jabstract  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import ServeEngine  # noqa: E402
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
PORTED = sorted(ARCHS)
DECODERS = ["deepseek-v2-lite-16b", "stablelm-12b", "qwen1.5-32b",
            "grok-1-314b", "nemotron-4-340b"]
FRONTENDS = ["hubert-xlarge", "llava-next-34b"]


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


def _tokens(cfg, n, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)


def _trajectories(pair, kv_dtype="bfloat16"):
    """Teacher-forced logits (B, 1 + STEPS, vocab) from both packages: a
    prompt prefill, then STEPS single-token decode steps fed the same
    tokens."""
    rcfg, rparams, tcfg, tparams = pair
    rcfg = dataclasses.replace(rcfg, kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    toks = _tokens(tcfg, PROMPT + STEPS)
    step = jax.jit(jdecode, static_argnums=0)
    jc = jinit_cache(rcfg, B, MAX_SEQ)
    tc = tm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    js, ts = [], []
    spans = [(0, PROMPT)] + [(PROMPT + t, PROMPT + t + 1)
                             for t in range(STEPS)]
    for lo, hi in spans:
        lj, jc = step(rcfg, rparams, {"tokens": jnp.asarray(toks[:, lo:hi]),
                                      "cache_pos": jnp.int32(lo)}, jc)
        lt, tc = tm.decode_step(tcfg, tparams, {
            "tokens": torch.from_numpy(toks[:, lo:hi]), "cache_pos": lo}, tc)
        js.append(np.asarray(lj[:, -1], np.float32))
        ts.append(lt[:, -1].float().numpy())
    return np.stack(js, 1), np.stack(ts, 1)


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


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_decode_logits_match_reference(pairs, name):
    ref, got = _trajectories(pairs(name))
    assert np.isfinite(got).all()
    diff = np.abs(ref - got)
    assert diff.max() <= ATOL, diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= RMS
    _margin_bound(ref, got)


@pytest.mark.parametrize("name", DECODERS)
def test_forward_without_cache_equals_prefill(pairs, name):
    """A forward without a cache keeps nothing and gives, bit for bit,
    the logits of a prefill through a cache of the prompt's length: the
    GQA and MLA blocks attend to the tokens' own K / V (or latents)."""
    _, _, cfg, params = pairs(name)
    toks = torch.from_numpy(_tokens(cfg, 24, seed=5))
    full, none = tm.forward(cfg, params, {"tokens": toks})
    pre, _ = tm.decode_step(cfg, params, {"tokens": toks, "cache_pos": 0},
                            tm.init_cache(cfg, B, 24, device="cpu"))
    assert none is None
    assert torch.equal(full, pre)


def _recording_routes(monkeypatch):
    """Wrap the router to record, per call, the chosen experts and the
    bf16 router logits they came from."""
    calls = []
    route = tlayers.route

    def recorded(flat, router, k):
        gates, experts = route(flat, router, k)
        calls.append((experts.clone(), (flat @ router).float()))
        return gates, experts
    monkeypatch.setattr(tlayers, "route", recorded)
    return calls


@pytest.mark.parametrize("name", DECODERS)
def test_decode_matches_forward(pairs, name, monkeypatch):
    """Teacher-forced single-token decode reproduces the logits of one
    forward over the whole sequence (smoke capacity never drops).

    The router's logits are bf16, and the batched forward and the
    single-token step round them from matmuls of other shapes, so a
    near-tie may choose another expert in the two runs.  The two runs'
    router logits must agree within 4 bf16 ulps of their magnitude, and a
    flip is allowed only where the forward's k-th and (k+1)-th logits lie
    closer than twice that difference, at most at 1 % of the token-layer
    choices; every position whose routing agrees in every layer meets
    the bound."""
    _, _, cfg, params = pairs(name)
    S = 32
    toks = torch.from_numpy(_tokens(cfg, S, seed=3))
    calls = _recording_routes(monkeypatch)
    full, _ = tm.decode_step(cfg, params, {"tokens": toks, "cache_pos": 0},
                             tm.init_cache(cfg, B, S, device="cpu"))
    fwd, calls[:] = list(calls), []
    cache = tm.init_cache(cfg, B, S, device="cpu")
    steps = []
    for t in range(S):
        lt, cache = tm.decode_step(cfg, params, {
            "tokens": toks[:, t:t + 1], "cache_pos": t}, cache)
        steps.append(lt[:, 0].float().numpy())
    agree = np.ones((B, S), bool)
    for layer, (experts, logits) in enumerate(fwd):
        k = experts.shape[1]
        step = [calls[t * len(fwd) + layer] for t in range(S)]
        dec = torch.stack([e for e, _ in step], 1).reshape(-1, k)
        dec_logits = torch.stack([lg for _, lg in step], 1).reshape(
            logits.shape)
        flip = (experts.sort(-1).values != dec.sort(-1).values).any(-1)
        srt = logits.sort(-1, descending=True).values
        gap = srt[:, k - 1] - srt[:, k]
        noise = (logits - dec_logits).abs().amax(-1)
        ulp = 2.0 ** (torch.floor(torch.log2(logits.abs().amax(-1))) - 7)
        assert (noise <= 4 * ulp).all(), (layer, noise.max())
        assert (gap[flip] <= 2 * noise[flip]).all(), (layer, gap[flip])
        assert int(flip.sum()) <= 0.01 * flip.numel() + 1
        agree &= ~flip.reshape(B, S).numpy()
    if not cfg.n_experts:
        assert agree.all()
    np.testing.assert_allclose(np.stack(steps, 1)[agree],
                               full.float().numpy()[agree],
                               rtol=0.15, atol=0.15)


def test_fp8_cache_tracks_bf16_and_reference(pairs):
    pair = pairs("deepseek-v2-lite-16b")
    cfg8 = dataclasses.replace(pair[2], kv_dtype="float8_e4m3fn")
    cache = tm.init_cache(cfg8, B, MAX_SEQ, device="cpu")
    assert cache["layers"]["c_kv"].dtype == torch.float8_e4m3fn
    assert cache["dense0"]["k_rope"].dtype == torch.float8_e4m3fn
    ref8, got8 = _trajectories(pair, "float8_e4m3fn")
    _, got16 = _trajectories(pair, "bfloat16")
    _margin_bound(got16, got8)
    _margin_bound(ref8, got8)


@pytest.mark.parametrize("cache_pos,S", [(0, 40), (40, 1)])
def test_mla_block_and_latent_cache_match_reference(pairs, cache_pos, S):
    rcfg, rparams, tcfg, tparams = pairs("deepseek-v2-lite-16b")
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["attn"])
    tp = tm._layer(tparams["layers"], 0)["attn"]
    rng = np.random.default_rng(cache_pos)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    r, rd = tcfg.kv_lora_rank, tcfg.qk_rope_dim
    c0 = (rng.standard_normal((B, MAX_SEQ, r)) * 0.5).astype(np.float32)
    k0 = (rng.standard_normal((B, MAX_SEQ, 1, rd)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(cache_pos + np.arange(S, dtype=np.int32)[None],
                          (B, S))
    jcache = {"c_kv": jnp.asarray(c0, jnp.bfloat16),
              "k_rope": jnp.asarray(k0, jnp.bfloat16)}
    want, new = jax.jit(lambda x, p, c: rlayers.mla_block(
        x, p, rcfg, positions=jnp.asarray(pos), cache=c,
        cache_pos=cache_pos))(jnp.asarray(x, jnp.bfloat16), rp, jcache)
    tcache = {"c_kv": torch.from_numpy(c0).to(torch.bfloat16),
              "k_rope": torch.from_numpy(k0).to(torch.bfloat16)}
    got = tlayers.mla_block(torch.from_numpy(x).to(torch.bfloat16), tp,
                            tcfg, positions=torch.from_numpy(pos.copy()),
                            cache=tcache, cache_pos=cache_pos)
    for kind in ("c_kv", "k_rope"):
        np.testing.assert_array_equal(
            tcache[kind].float().numpy(), np.asarray(new[kind], np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (B, S, tcfg.d_model)
    ulp = 2.0 ** -7 * 2.0 ** np.floor(np.log2(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * ulp)


def test_params_from_jax_is_bit_exact_and_checked(pairs):
    rcfg, rparams, tcfg, tparams = pairs("deepseek-v2-lite-16b")
    for path in (("layers", "moe", "w1"), ("dense0", "attn", "w_uk"),
                 ("layers", "moe", "shared", "w2"), ("layers", "moe",
                                                     "router")):
        want, got = rparams, tparams
        for k in path:
            want, got = want[k], got[k]
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    tree = jax.tree.map(np.asarray, rparams)
    w3 = tree["layers"]["moe"]["w3"]
    tree["layers"]["moe"]["w3"] = w3[:, :-1]
    with pytest.raises(ValueError, match="w3"):
        tm.params_from_jax(tcfg, tree, device="cpu")
    tree["layers"]["moe"]["w3"] = w3
    del tree["dense0"]
    with pytest.raises(KeyError, match="dense0"):
        tm.params_from_jax(tcfg, tree, device="cpu")
    # every arch, every leaf: the reference's dtype (the SSMs' f32 A_log
    # and dt_bias stay f32) and its bits
    for name in PORTED:
        _, rparams, _, tparams = pairs(name)
        for path, want in jax.tree_util.tree_flatten_with_path(rparams)[0]:
            got = tparams
            for k in path:
                got = got[k.key]
            want = np.asarray(want)
            assert str(got.dtype).split(".")[-1] == want.dtype.name, path
            bits = np.int32 if want.dtype == np.float32 else np.int16
            np.testing.assert_array_equal(
                got.view(getattr(torch, bits.__name__)).numpy(),
                want.view(bits))


@pytest.mark.parametrize("name", PORTED)
def test_schema_matches_reference_tree(pairs, name):
    """Every leaf of the reference's parameter tree, at its shape and
    dtype, and no other: the schema carries dense0, the MLA and MoE
    leaves, the layernorm biases, the Mamba1 / Mamba2 blocks with their
    f32 ``A_log`` / ``dt_bias``, the hybrid's shared block, and no
    ``embed`` for a frontend model."""
    rcfg, rparams, tcfg, _ = pairs(name)
    flat = {jax.tree_util.keystr(p): (tuple(a.shape), a.dtype.name)
            for p, a in jax.tree_util.tree_flatten_with_path(
                jabstract(rcfg))[0]}
    assert flat == {jax.tree_util.keystr(p): (tuple(a.shape), a.dtype.name)
                    for p, a in jax.tree_util.tree_flatten_with_path(
                        rparams)[0]}
    mine = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                dtype = str(tm.leaf_dtype(v[1])).split(".")[-1]
                mine["".join(f"['{p}']" for p in path + (k,))] = (v[0], dtype)
    walk(tm.schema(tcfg), ())
    assert mine == flat


def test_seeded_init_fan_in_and_zeros():
    cfg = smoke_config(ARCHS["deepseek-v2-lite-16b"])
    a = tm.init_params(cfg, seed=5, device="cpu")
    b = tm.init_params(cfg, seed=5, device="cpu")
    assert torch.equal(a["layers"]["moe"]["w1"], b["layers"]["moe"]["w1"])
    w1 = a["layers"]["moe"]["w1"]                  # (L, E, d, fe): fan-in d
    assert w1.shape == (1, 4, cfg.d_model, cfg.moe_d_ff)
    std = float(w1.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert a["dense0"]["mlp"]["w1"].shape == (1, cfg.d_model, cfg.d_ff)
    lcfg = smoke_config(ARCHS["stablelm-12b"])
    p = tm.init_params(lcfg, seed=0, device="cpu")
    for leaf in (p["final_norm"]["bias"], p["layers"]["attn"]["norm"]["bias"],
                 p["layers"]["mlp"]["norm"]["bias"]):
        assert leaf.dtype == torch.bfloat16 and not bool(leaf.any())


def test_cache_layout_matches_reference():
    """Every arch's cache: the reference's leaves at their shapes, dtypes
    and fill (the SSMs' f32 ``ssm``, the hybrid's int32 ``attn_pos`` at
    -2 * window), in bf16 and fp8."""
    for name in PORTED:
        for kv in ("bfloat16", "float8_e4m3fn"):
            cfg = dataclasses.replace(smoke_config(ARCHS[name]), kv_dtype=kv)
            rcfg = dataclasses.replace(smoke_config(RARCHS[name]), kv_dtype=kv)
            rc = jax.tree_util.tree_flatten_with_path(jinit_cache(rcfg, 2, 48))
            tc = jax.tree_util.tree_flatten_with_path(
                tm.init_cache(cfg, 2, 48, device="cpu"))
            want = {jax.tree_util.keystr(p): (tuple(a.shape), a.dtype.name,
                                              np.unique(np.asarray(a)
                                                        .astype(np.float32)))
                    for p, a in rc[0]}
            got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                             str(t.dtype).split(".")[-1],
                                             np.unique(t.float().numpy()))
                   for p, t in tc[0]}
            assert got.keys() == want.keys(), name
            for k in got:
                assert got[k][:2] == want[k][:2], (name, k)
                np.testing.assert_array_equal(got[k][2], want[k][2])


@pytest.mark.parametrize("name", FRONTENDS)
def test_engines_refuse_encoder_and_frontend_models(pairs, name):
    """The serving engine feeds token ids: an encoder-only model (no
    decode step) or an embeds-fed one is refused with a ValueError at
    construction, by the engine, the scheduler and the CLI's ``serve``
    (the reference's engine fails deep inside); the model runs them."""
    _, _, cfg, params = pairs(name)
    with pytest.raises(ValueError, match=cfg.name):
        ServeEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match=cfg.name):
        tserving.ServeScheduler(cfg, params, device="cpu")
    with pytest.raises(ValueError, match=cfg.name):
        tserve.serve(arch=name, smoke=True, torch_device="cpu", params=params)
    if not cfg.causal:
        with pytest.raises(ValueError, match="encoder-only"):
            tm.decode_step(cfg, params, {"embeds": torch.zeros(
                1, 1, cfg.d_model), "cache_pos": 0},
                tm.init_cache(cfg, 1, 8, device="cpu"))


def _embeds(cfg, S, seed=21):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def test_encoder_forward_matches_reference(pairs):
    """hubert-xlarge: bidirectional attention, no RoPE, layernorm, GELU,
    from embeds, with no cache."""
    rcfg, rparams, tcfg, tparams = pairs("hubert-xlarge")
    emb = _embeds(tcfg, 48)
    want, _, _ = jax.jit(lambda p, b: jforward(rcfg, p, b))(
        rparams, {"embeds": jnp.asarray(emb, jnp.bfloat16)})
    got, cache = tm.forward(tcfg, tparams, {"embeds": torch.from_numpy(emb)})
    assert cache is None and got.shape == (B, 48, tcfg.vocab)
    want = np.asarray(want, np.float32)
    diff = np.abs(want - got.float().numpy())
    assert diff.max() <= ATOL and np.sqrt(np.mean(diff ** 2)) <= RMS
    # bidirectional: the first position sees the last
    emb2 = emb.copy()
    emb2[:, -1] += 1.0
    got2, _ = tm.forward(tcfg, tparams, {"embeds": torch.from_numpy(emb2)})
    assert not torch.equal(got2[:, 0], got[:, 0])


def test_frontend_decode_matches_forward_and_reference(pairs):
    """llava-next-34b from embeds: a prompt prefill and teacher-forced
    single-embed steps against the reference's jitted ``decode_step`` and
    against the port's own forward over the whole sequence."""
    rcfg, rparams, tcfg, tparams = pairs("llava-next-34b")
    emb = _embeds(tcfg, PROMPT + STEPS)
    spans = [(0, PROMPT)] + [(PROMPT + t, PROMPT + t + 1)
                             for t in range(STEPS)]
    step = jax.jit(jdecode, static_argnums=0)
    jc = jinit_cache(rcfg, B, MAX_SEQ)
    tc = tm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    js, ts = [], []
    for lo, hi in spans:
        piece = emb[:, lo:hi]
        lj, jc = step(rcfg, rparams, {"embeds": jnp.asarray(piece,
                                                            jnp.bfloat16),
                                      "cache_pos": jnp.int32(lo)}, jc)
        lt, tc = tm.decode_step(tcfg, tparams, {
            "embeds": torch.from_numpy(piece), "cache_pos": lo}, tc)
        js.append(np.asarray(lj[:, -1], np.float32))
        ts.append(lt[:, -1].float().numpy())
    ref, got = np.stack(js, 1), np.stack(ts, 1)
    diff = np.abs(ref - got)
    assert diff.max() <= ATOL and np.sqrt(np.mean(diff ** 2)) <= RMS
    _margin_bound(ref, got)
    full, _ = tm.forward(tcfg, tparams, {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(
        got, full[:, [hi - 1 for _, hi in spans]].float().numpy(),
        rtol=0.15, atol=0.15)


def test_serve_cli_deepseek_smoke_and_unported(monkeypatch, capsys):
    argv = ["serve", "--arch", "deepseek-v2-lite-16b", "--smoke", "--cpu",
            "--prompt-len", "192", "--tokens", "4", "--requests", "1",
            "--hbm-kv-budget", "8192"]
    monkeypatch.setattr("sys.argv", argv)
    tserve.main()
    out = capsys.readouterr().out
    assert "generated tok/s" in out and "spilled pages 2, read back 2" in out
    for arch in ("falcon-mamba-7b", "zamba2-7b"):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", arch, "--smoke", "--cpu", "--prompt-len", "80",
            "--tokens", "4", "--requests", "1"])
        tserve.main()
        out = capsys.readouterr().out
        assert f"arch={arch}" in out and "generated tok/s" in out
        assert "spilled pages 0, read back 0, gathered 0" in out
    for arch in FRONTENDS:
        monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke",
                                         "--cpu"])
        with pytest.raises(ValueError, match=arch):
            tserve.main()
