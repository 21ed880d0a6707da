"""Port vs reference: serving an MLA + MoE decoder (deepseek-v2-lite-16b
at ``smoke_config``) through the tier — the ``c_kv`` latent is the paged
KV kind.

* pools fed the same ``c_kv`` pages (512 channels a token, the latent's
  full width) store byte-identical payloads, flags and receipts;
* ``ServeEngine`` with the reference's weights tracks the reference
  engine: teacher-forced logits within the margin-aware bound of
  ``tests/test_kv_dtype.py``, equal spilled-page counts and logical bytes.
  The port's router logits are bf16, as the reference's source has them,
  but its compiled CPU graph keeps them in f32, so where two bf16 logits
  tie (or lie within 2 bf16 ulps) at the k-th choice the two engines may
  route a token apart; such positions (at most a quarter) are left out
  of the bound, every other one is held to it;
* a covering PNM gather decodes token-identically to classic readback;
* ``importance="attention"`` ranks ``c_kv`` pages as the reference does
  on one cache array (masses within f32 rounding, rel 1e-4);
* the admission projection equals the reference's;
* the ``dense0`` layer's cache and every ``k_rope`` stay on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.core import synth  # noqa: E402
from repro.runtime import KVPagePool as RPool  # noqa: E402
from repro.runtime import ServeEngine as RServe  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro.runtime import serving as rserving  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import KVPagePool as TPool  # noqa: E402
from repro_torch.runtime import ServeEngine as TServe  # noqa: E402
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

ARCH = "deepseek-v2-lite-16b"
ENGINE = dict(max_seq=96, batch=1, page_tokens=16, hbm_kv_budget=1 << 11)
POLICIES = {"paper": (tpaging.PAPER_POLICY, rpaging.PAPER_POLICY),
            "lossless": (tpaging.LOSSLESS_POLICY, rpaging.LOSSLESS_POLICY)}


@pytest.fixture(scope="module")
def models(smoke_model):
    rcfg, rparams = smoke_model(ARCH)
    tcfg = smoke_config(ARCHS[ARCH])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.mark.parametrize("policy", ["paper", "lossless"])
def test_pools_fed_same_latent_pages_identical(policy):
    """c_kv pages of 16 tokens x 512 channels through both pools: spill
    order, readback words, stored payloads, per-page traffic receipts and
    I/O time identical."""
    C, page = 512, 16
    kv = synth.kv_cache(page * 12, C, seed=5)
    budget = 4 * page * C * 2
    tpool = TPool("trace", page, budget, POLICIES[policy][0],
                  key_prefix="s0.", device="cpu")
    rpool = RPool("trace", page, budget, POLICIES[policy][1],
                  key_prefix="s0.")
    outs = []
    for pool in (tpool, rpool):
        spilled = []
        for b in range(4):                   # four commit boundaries
            pages = [(layer, "c_kv", 48 * b + page * i,
                      kv[48 * b + page * i: 48 * b + page * (i + 1)],
                      float(48 * b + page * i))
                     for i in range(3) for layer in (0, 1)]
            pool.append_pages(pages)
            events, pool.spill_events = pool.spill_events, []
            spilled.append(([p.key for p in events], pool.read_pages(events)))
        outs.append((spilled, pool.read_layer(1, "c_kv")))
    for (tk, td), (rk, rd) in zip(outs[0][0], outs[1][0]):
        assert tk == rk
        for a, b in zip(td, rd, strict=True):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    tdev, rdev = tpool.tier, rpool.device
    assert tdev._tensors.keys() == rdev._tensors.keys()
    for key in rdev._tensors:
        assert [b.payloads for b in tdev._tensors[key]] == \
            [b.payloads for b in rdev._tensors[key]]
        assert [b.flags for b in tdev._tensors[key]] == \
            [b.flags for b in rdev._tensors[key]]
    assert tpool.page_traffic.keys() == rpool.page_traffic.keys()
    for key, t in tpool.page_traffic.items():
        assert vars(t) == vars(rpool.page_traffic[key])
    assert vars(tdev.stats) == vars(rdev.stats)
    assert (tpool.io_service_s, tpool.io_queue_delay_s) == \
        (rpool.io_service_s, rpool.io_queue_delay_s)
    assert tpool.spilled_pages == rpool.spilled_pages > 0


def _near_ties(monkeypatch, k_ulps=2):
    """Record, per router call, whether the last token's k-th and
    (k+1)-th bf16 logits lie within ``k_ulps`` ulps of their magnitude."""
    from repro_torch.models import layers as tlayers
    ties = []
    route = tlayers.route

    def recorded(flat, router, k):
        logits = (flat[-1:] @ router).float()[0]
        srt = logits.sort(descending=True).values
        ulp = 2.0 ** (torch.floor(torch.log2(logits.abs().max())) - 7)
        ties.append(bool(srt[k - 1] - srt[k] <= k_ulps * ulp))
        return route(flat, router, k)
    monkeypatch.setattr(tlayers, "route", recorded)
    return ties


def _teacher_forced(eng, tokens, n_prompt):
    logits = [eng.prefill(tokens[:, :n_prompt])]
    for t in range(n_prompt, tokens.shape[1]):
        logits.append(eng.decode(tokens[:, t : t + 1]))
    return np.stack([np.asarray(x, np.float32) for x in logits], 1)


@pytest.mark.parametrize("policy", ["paper", "lossless"])
def test_engine_tracks_reference_engine(models, policy, monkeypatch):
    rcfg, rparams, tcfg, tparams = models
    teng = TServe(tcfg, tparams, policy=POLICIES[policy][0], device="cpu",
                  **ENGINE)
    reng = RServe(rcfg, rparams, policy=POLICIES[policy][1], **ENGINE)
    toks = (np.arange(60, dtype=np.int32).reshape(1, 60) * 7) % tcfg.vocab
    ties = _near_ties(monkeypatch)
    got = _teacher_forced(teng, toks, 48)
    ref = _teacher_forced(reng, toks, 48)
    n_moe = tm.cfg_layers(tcfg)
    tied = np.asarray(ties).reshape(-1, n_moe).any(-1)
    assert tied.shape == (13,) and tied.mean() <= 0.25
    got, ref = got[:, ~tied], ref[:, ~tied]
    ts, rs = teng.stats(), reng.stats()
    assert ts.spilled_pages == rs.spilled_pages > 0
    assert ts.kv_logical_bytes == rs.kv_logical_bytes
    assert teng.pool.stats().raw_bytes_stored == \
        reng.pool.stats().raw_bytes_stored
    assert ts.tier_dram_read > 0
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    assert rms < 0.5 * float(np.median(margin)), (rms, np.median(margin))
    assert agree[margin > 4.0 * rms].all()
    assert agree.mean() > 0.8
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99


def test_only_stacked_latents_are_paged(models):
    """Pages are c_kv windows of the stacked layers alone: the dense0
    layer's cache and every k_rope stay on the card, as in the
    reference; a spilled page's readback lands in the c_kv cache."""
    _, _, tcfg, tparams = models
    eng = TServe(tcfg, tparams, device="cpu", **ENGINE)
    prompt = (np.arange(64, dtype=np.int32).reshape(1, 64) * 3) % tcfg.vocab
    eng.generate(prompt, 20)
    pages = eng.pool.iter_pages()
    n_layers = tm.cfg_layers(tcfg)
    assert {p.kind for p in pages} == {"c_kv"}
    assert {p.layer for p in pages} == set(range(n_layers))
    assert len(pages) == (84 // 16) * n_layers
    assert eng.pool.spilled_pages > 0 and eng.pool.pages_read > 0
    assert set(eng.cache) == {"layers", "dense0"}
    for layer in range(n_layers):
        want = eng.cache["layers"]["c_kv"][layer, 0, :80].contiguous()
        got = eng.kv_through_tier(layer, "c_kv")
        assert got.shape == (80, tcfg.kv_lora_rank)
        # classic readback wrote the tier's words at each page's view
        # into the cache, so the cache equals the tier's view of it
        np.testing.assert_array_equal(
            got, want.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("async_io", [False, True])
def test_covering_gather_decodes_like_classic(models, async_io):
    _, _, tcfg, tparams = models
    prompt = (np.arange(48, dtype=np.int32).reshape(1, 48) * 5) % tcfg.vocab
    runs = []
    for pnm in (None, 1_000):
        eng = TServe(tcfg, tparams, pnm_topk=pnm, async_io=async_io,
                     device="cpu", **ENGINE)
        runs.append((eng.generate(prompt, 12), eng))
    (t_base, e_base), (t_pnm, e_pnm) = runs
    np.testing.assert_array_equal(t_base, t_pnm)
    assert e_pnm.pool.pages_gathered == e_base.pool.pages_read > 0
    assert e_pnm.stats().tier_device_compute_s > 0


@pytest.mark.parametrize("pos", [40, 48, 70])
def test_latent_digest_and_attention_masses_on_the_same_cache(models, pos):
    """The port's c_kv digest and attention masses against the
    reference's on one cache array; the masses key by (kind, layer,
    start)."""
    rcfg, rparams, tcfg, tparams = models
    kw = dict(ENGINE, pnm_topk=2, importance="attention")
    teng = TServe(tcfg, tparams, device="cpu", **kw)
    reng = RServe(rcfg, rparams, **kw)
    shape = tuple(teng.cache["layers"]["c_kv"].shape)
    x = (np.random.default_rng(pos).standard_normal(shape) * 0.7).astype(
        np.float32)
    teng.cache["layers"]["c_kv"] = torch.from_numpy(x).to(torch.bfloat16)
    reng.cache["layers"]["c_kv"] = jax.numpy.asarray(
        x, dtype=reng.cache["layers"]["c_kv"].dtype)
    teng.pos = reng.pos = pos
    np.testing.assert_allclose(teng._digest("c_kv").numpy(),
                               reng._query_digest("c_kv"), rtol=1e-5,
                               atol=1e-6)
    got, want = teng._attention_masses(), reng._attention_masses()
    assert sorted(got) == sorted(want)
    assert {kind for kind, _, _ in got} == {"c_kv"}
    for key, m in got.items():
        assert m == pytest.approx(want[key], rel=1e-4, abs=1e-7)


def test_attention_importance_ranks_latent_pages_as_reference(models):
    """Bounded gathers with importance="attention": the accumulated
    per-page masses track the reference engine's (the two models' KV
    differs by bf16 rounding) and every page key is known to the pool."""
    rcfg, rparams, tcfg, tparams = models
    kw = dict(ENGINE, async_io=False, pnm_topk=2, importance="attention")
    teng = TServe(tcfg, tparams, device="cpu", **kw)
    reng = RServe(rcfg, rparams, **kw)
    toks = (np.arange(72, dtype=np.int32).reshape(1, 72) * 7) % tcfg.vocab
    _teacher_forced(teng, toks, 48)
    _teacher_forced(reng, toks, 48)
    assert teng._imp_acc.keys() == reng._imp_acc.keys() != set()
    for key, m in reng._imp_acc.items():
        assert teng._imp_acc[key] == pytest.approx(m, rel=0.05, abs=1e-3)
    assert teng.pool.unknown_importance_keys == 0
    assert teng.pool.pages_gathered > 0


@pytest.fixture
def ref_slope_cache():
    """Leave the reference's process-wide ``_kv_bytes_per_token_b1``
    cache (``lru_cache(maxsize=32)``) as empty as this test found it in a
    fresh process: ``tests/test_prefix_share.py`` bounds its size, and
    xdist may run that file after this one in the same worker."""
    yield
    rserving._kv_bytes_per_token_b1.cache_clear()


def test_kv_projection_equals_reference(models, ref_slope_cache):
    rcfg, _, tcfg, _ = models
    for t, r in ((tcfg, rcfg), (ARCHS[ARCH], RARCHS[ARCH])):
        assert tserving._kv_bytes_per_token_b1(t) == \
            rserving._kv_bytes_per_token_b1(r)
        for batch, total in ((1, 576), (2, 100), (1, 63)):
            assert tserving.projected_kv_bytes(t, batch, total, 64) == \
                rserving.projected_kv_bytes(r, batch, total, 64)
    assert tserving._kv_bytes_per_token_b1(ARCHS[ARCH]) == 26 * 512 * 2


def test_serve_entry_point_deepseek_on_cpu(capsys):
    rep = serve(arch=ARCH, smoke=True, prompt_len=48, n_tokens=6,
                requests=1, hbm_kv_budget=1 << 11, page_tokens=16,
                torch_device="cpu")
    assert rep.spilled_pages > 0 and rep.readback_pages > 0
    assert rep.kv_compression_ratio > 1.0
    assert rep.tokens[0].shape == (1, 6)
    assert "arch=deepseek-v2-lite-16b" in capsys.readouterr().out
