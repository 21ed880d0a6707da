"""Port vs reference: the PNM read path.

* scoring (``kernels.pnm_score``): the plain version against the
  reference's numpy twin and its Pallas kernel (interpret mode), within
  the f32 summation bound ``C * eps32 * max_t sum_c |row_tc * digest_c|``
  (the two sum each dot in different orders); ragged pages, the ``-inf``
  page, NaN rows, and a page's score bitwise the same in any batch; the
  card tests' pages (``tests/torch_kv_score_cases.py``: C from 1 to 1024,
  NaN and inf only past ``valid``);
* ``topk_select`` against the JAX tie-break;
* tier gathers: receipts identical to the reference's field by field
  except ``gather.scores`` (the bound above), winners and their bytes
  identical, for ``word`` and ``bitplane-kv``, sync and async, k in
  {0, 1, 3, all}; the write-after-read fence covers every key a queued
  gather touches;
* the pool's ``gather_topk`` family and importance feedback (unknown
  keys counted and warned about once, as the reference's default);
* the engine: covering ``pnm_topk`` reads back exactly what classic
  readback does (identical tokens, 1 and 4 shards), and bounded
  ``pnm_topk`` with attention importance tracks the JAX engine.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import synth  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro.kernels import pnm_score as rpnm  # noqa: E402
from repro.runtime import ServeEngine as RServe  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402
from repro_torch.kernels import pnm_score as tpnm  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import ServeEngine as TServe  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402
import torch_kv_score_cases as cases  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CH = 64          # KV channels for the tier-level tests
ROWS = 32        # tokens per written stream
EPS32 = float(np.finfo(np.float32).eps)


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 → bf16 bit patterns (truncation)."""
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _score_bound(u16_rows, digest):
    """Per-page f32 summation bound of a masked max of row dots."""
    return np.array([len(digest) * EPS32 * float(
        np.abs(_f32(r) * digest).sum(axis=-1).max(initial=0.0))
        for r in u16_rows])


def _plain(u16, valid, digest):
    return tpnm.page_scores(torch.from_numpy(u16.view(np.int16)),
                            torch.from_numpy(np.asarray(valid, np.int32)),
                            torch.from_numpy(digest)).numpy()


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [64, 128, 40])
def test_page_scores_match_reference_numpy_and_pallas(C):
    rng = np.random.default_rng(C)
    u16 = _bf16(rng.normal(size=(6, 16, C)))
    valid = np.array([16, 9, 1, 16, 0, 5])
    digest = rng.normal(size=C).astype(np.float32)
    got = _plain(u16, valid, digest)
    bound = _score_bound([u16[i, :v] for i, v in enumerate(valid)], digest)
    for force in ("numpy", "pallas"):
        ref = rpnm.page_scores(_f32(u16), valid, digest, force=force)
        assert got[4] == ref[4] == -np.inf
        live = valid > 0
        assert (np.abs(got[live] - ref[live]) <= bound[live]).all(), force


@pytest.mark.parametrize("P,T,C", cases.SCORE_SHAPES_CPU)
def test_page_scores_edge_pages_match_reference(P, T, C):
    """The card tests' pages: NaN where the reference has NaN, -inf
    exactly where it has -inf, the rest within the summation bound (or
    equal, for inf); NaN and inf past valid change nothing."""
    u16, valid, digest = cases.score_case(P, T, C, seed=P * T + C)
    got = _plain(u16, valid, digest)
    bound = _score_bound([u16[i, :v] for i, v in enumerate(valid)], digest)
    for force in ("numpy", "pallas"):
        ref = rpnm.page_scores(_f32(u16), valid, digest, force=force)
        nan = np.isnan(ref)
        assert (np.isnan(got) == nan).all(), force
        assert ((got == -np.inf) == (ref == -np.inf)).all(), force
        live = ~nan
        close = (got[live] == ref[live]) | (
            np.abs(got[live] - ref[live]) <= bound[live])
        assert close.all(), force
    assert got[0] == -np.inf and np.isnan(got[1])
    if P > 4:
        assert np.isfinite(got[3]) or valid[3] == 0
        assert np.isfinite(got[4]) or valid[4] == 0


def test_page_scores_u16_ragged_matches_reference():
    kv = synth.kv_cache(24 + 40 + 7, CH, seed=3)
    pages = [kv[:16], kv[16:24], kv[24:64], kv[64:]]     # 16, 8, 40, 7 rows
    digest = np.linspace(-1, 1, CH).astype(np.float32)
    got = tpnm.page_scores_u16(pages, digest, "cpu")
    ref = rpnm.page_scores_u16(pages, digest, force="numpy")
    assert got.dtype == np.float32 and got.shape == (4,)
    assert (np.abs(got - ref) <= _score_bound(pages, digest)).all()
    assert tpnm.page_scores_u16([], digest, "cpu").shape == (0,)
    with pytest.raises(ValueError, match="channel"):
        tpnm.page_scores_u16([kv[:3, :10]], digest, "cpu")


def test_page_scores_nan_inf_and_masking():
    """NaN in a valid row propagates (as np.max does); NaN past valid is
    never read; inf * 0 in a dot gives NaN; inf alone gives inf."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 8, CH)).astype(np.float32)
    digest = rng.normal(size=CH).astype(np.float32)
    digest[7] = 0.0
    x[0, 3, 2] = np.nan                  # valid row → NaN page
    x[1, 6, 2] = np.nan                  # masked row (valid = 4) → finite
    x[2, 0, 7] = np.inf                  # inf * 0 → NaN page
    x[3, 1, 5] = np.inf * np.sign(digest[5])   # → +inf page
    u16 = _bf16(x)
    valid = np.array([8, 4, 8, 8, 0])
    got = _plain(u16, valid, digest)
    ref = rpnm.page_scores(_f32(u16), valid, digest, force="numpy")
    assert np.isnan(got[0]) and np.isnan(ref[0])
    assert np.isfinite(got[1]) and np.isfinite(ref[1])
    assert np.isnan(got[2]) and np.isnan(ref[2])
    assert got[3] == ref[3] == np.inf
    assert got[4] == ref[4] == -np.inf
    # NaN ranks last, after -inf, in the reference's tie-break
    assert tpnm.topk_select(got, 5) == rpnm.topk_select(ref, 5) \
        == [3, 1, 4, 0, 2]


def test_page_score_independent_of_batch():
    """A page's score is bitwise the same alone, in a larger batch padded
    to another T, and at another position — and byte-identical pages tie
    exactly."""
    rng = np.random.default_rng(7)
    pages = [_bf16(rng.normal(size=(t, CH)) * 3) for t in (5, 16, 1, 33, 9)]
    pages.append(pages[1].copy())
    digest = rng.normal(size=CH).astype(np.float32)
    batch = tpnm.page_scores_u16(pages, digest, "cpu")
    alone = np.array([tpnm.page_scores_u16([p], digest, "cpu")[0]
                      for p in pages])
    flipped = tpnm.page_scores_u16(pages[::-1], digest, "cpu")[::-1]
    pad = np.zeros((200, CH), np.uint16)
    padded = tpnm.page_scores_u16(pages + [pad], digest, "cpu")[:-1]
    for other in (alone, flipped, padded):
        assert other.tobytes() == batch.tobytes()
    assert batch[1] == batch[5]
    order = tpnm.topk_select(batch, len(pages))
    assert order.index(1) + 1 == order.index(5)      # tie: position order


def test_topk_select_matches_reference():
    scores = np.array([1.0, 3.0, 3.0, 0.5, 3.0])
    assert tpnm.topk_select(scores, 3) == [1, 2, 4]
    assert tpnm.topk_select(scores, 0) == []
    assert tpnm.topk_select(scores, 99) == [1, 2, 4, 0, 3]
    assert tpnm.topk_select(np.array([]), 4) == []
    rng = np.random.default_rng(0)
    tied = rng.integers(0, 5, 40).astype(np.float32)
    tied[::7] = np.nan
    tied[1::9] = -np.inf
    for k in (0, 1, 5, 40, 50):
        assert tpnm.topk_select(tied, k) == rpnm.topk_select(tied, k)


# ---------------------------------------------------------------------------
# Tier gathers against the reference
# ---------------------------------------------------------------------------

RECEIPT_FIELDS = [f.name for f in dataclasses.fields(ttier.Receipt)
                  if f.name not in ("data", "gather")]


def same_receipts(trecs, rrecs):
    """Every receipt field equal; gather winners and bytes equal, scores
    within the f32 summation bound (relative to the score's size)."""
    assert len(trecs) == len(rrecs)
    for x, y in zip(trecs, rrecs):
        for f in RECEIPT_FIELDS:
            assert getattr(x, f) == getattr(y, f), (y.key, f)
        for a, b in ((x.data, y.data),):
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)
        assert (x.gather is None) == (y.gather is None)
        if y.gather is not None:
            g, r = x.gather, y.gather
            assert (g.keys, g.indices) == (r.keys, r.indices)
            assert g.scores.dtype == np.float32
            np.testing.assert_allclose(g.scores, r.scores, rtol=CH * EPS32,
                                       atol=1e-6)
            assert len(g.data) == len(r.data)
            for a, b in zip(g.data, r.data):
                np.testing.assert_array_equal(a, b)


def _gather_script(mod, pmod, k):
    """Writes (one stream left partial, so a gather flushes it), reads
    and gathers mixed in batches, with per-key winner views."""
    kv = synth.kv_cache(ROWS * 7, CH, seed=11)
    keys = tuple(f"p{i}" for i in range(6))
    W, R, G, KV = mod.WriteReq, mod.ReadReq, mod.GatherReq, mod.KV
    views = (pmod.FULL, pmod.MAN4, pmod.MAN0, pmod.FULL, pmod.MAN4, pmod.FULL)
    kk = len(keys) + 2 if k == "all" else k
    d1 = np.linspace(-1, 1, CH).astype(np.float32)
    d2 = np.cos(np.arange(CH)).astype(np.float32)
    return [
        [W(key, kv[i * ROWS:(i + 1) * ROWS], kind=KV)
         for i, key in enumerate(keys)]
        + [W("tail", kv[6 * ROWS:6 * ROWS + 9], kind=KV, flush=False)],
        [G(keys, d1, kk, views=views), R("p1", kind=KV, view=pmod.MAN4),
         G(keys[::-1] + ("tail",), d2, kk)],
        [W("p2", kv[:ROWS], kind=KV), G(keys[1:4], d2, kk),
         R("p2", kind=KV)],
    ]


def _run(mod, pmod, layout, mode, k):
    dev = mod.TierStore(layout, kv_window=ROWS, window=3, sanitize=True,
                        **({"device": "cpu"} if mod is ttier else {}))
    batches = _gather_script(mod, pmod, k)
    if mode == "sync":
        recs = [r for b in batches for r in dev.submit(b)]
    else:
        tickets = [t for b in batches for t in dev.submit_async(b)]
        recs = [t.wait() for t in tickets[::-1]][::-1]
    dev.quiesce()
    return dev, recs


@pytest.mark.parametrize("k", [0, 1, 3, "all"])
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("layout", ["word", "bitplane-kv"])
def test_gather_identical_to_reference(layout, mode, k):
    td, trecs = _run(ttier, tprec, layout, mode, k)
    rd, rrecs = _run(rtier, rprec, layout, mode, k)
    same_receipts(trecs, rrecs)
    gathers = [r for r in trecs if r.op == "gather"]
    assert len(gathers) == 3
    want = {0: 0, 1: 1, 3: 3, "all": None}[k]
    for g, n in zip(gathers, (6, 7, 3)):
        assert len(g.gather.scores) == n
        assert len(g.gather.keys) == (n if want is None else min(want, n))
        assert g.device_compute_s > 0
    for f in dataclasses.fields(rd.stats):
        assert getattr(td.stats, f.name) == getattr(rd.stats, f.name), f.name
    assert (td._now_s, td._ddr_free_s, td._link_free_s) == \
        (rd._now_s, rd._ddr_free_s, rd._link_free_s)


@pytest.mark.parametrize("layout", ["word", "bitplane-kv"])
def test_covering_gather_byte_identical_to_reads(layout):
    dev = ttier.TierStore(layout, kv_window=ROWS, sanitize=True, device="cpu")
    kv = synth.kv_cache(ROWS * 6, CH, seed=0)
    keys = [f"p{i}" for i in range(6)]
    dev.submit([ttier.WriteReq(k, kv[i * ROWS:(i + 1) * ROWS], kind=ttier.KV)
                for i, k in enumerate(keys)])
    views = tuple([tprec.MAN0, tprec.FULL, tprec.MAN4] * 2)
    rec, = dev.submit([ttier.GatherReq(tuple(keys), np.ones(CH, np.float32),
                                       k=9, views=views)])
    assert sorted(rec.gather.keys) == keys
    plain = {k: r.data for k, r in zip(keys, dev.submit(
        [ttier.ReadReq(k, kind=ttier.KV, view=v)
         for k, v in zip(keys, views)]))}
    for k, data in zip(rec.gather.keys, rec.gather.data):
        np.testing.assert_array_equal(data, plain[k])
    score, = dev.submit([ttier.GatherReq(tuple(keys), np.ones(CH, np.float32),
                                         k=0)])
    assert score.link_bytes_out == 4 * len(keys) and score.gather.data == []


def _fence_run(mod):
    """A queued gather over (a, b, c) and a later posted write to b: the
    gather must see b as it was when the gather was queued."""
    kv = synth.kv_cache(ROWS * 4, CH, seed=2)
    dev = mod.TierStore("bitplane-kv", kv_window=ROWS, window=8,
                        sanitize=True,
                        **({"device": "cpu"} if mod is ttier else {}))
    keys = ("a", "b", "c")
    dev.submit([mod.WriteReq(k, kv[i * ROWS:(i + 1) * ROWS], kind=mod.KV)
                for i, k in enumerate(keys)])
    before = dev.submit([mod.ReadReq("b", kind=mod.KV)])[0].data
    t, = dev.submit_async([mod.GatherReq(keys, np.ones(CH, np.float32), k=3)])
    assert not t.done
    w, = dev.submit_async([mod.WriteReq("b", kv[3 * ROWS:], kind=mod.KV)])
    assert t.done              # the fence flushed the queued gather first
    rec = t.wait()
    return before, rec, w.wait(), dev


def test_write_fence_covers_every_gather_candidate():
    before, rec, wrec, td = _fence_run(ttier)
    data = dict(zip(rec.gather.keys, rec.gather.data))
    np.testing.assert_array_equal(data["b"], before)
    assert data["b"].shape == (ROWS, CH)
    _, rrec, rwrec, rd = _fence_run(rtier)
    same_receipts([rec, wrec], [rrec, rwrec])
    assert (td._now_s, td._ddr_free_s, td._link_free_s) == \
        (rd._now_s, rd._ddr_free_s, rd._link_free_s)
    assert td.submit([ttier.ReadReq("b", kind=ttier.KV)])[0].data.shape == \
        (2 * ROWS, CH)


@pytest.mark.parametrize("bad", ["k", "digest", "views", "key", "channels",
                                 "view"])
def test_gather_validation_matches_reference(bad):
    kv = synth.kv_cache(ROWS, CH, seed=1)
    errs = []
    for mod, pmod in ((ttier, tprec), (rtier, rprec)):
        dev = mod.TierStore("bitplane-kv", kv_window=ROWS,
                            **({"device": "cpu"} if mod is ttier else {}))
        dev.submit([mod.WriteReq("a", kv, kind=mod.KV)])
        d = np.ones(CH, np.float32)
        req = {
            "k": mod.GatherReq(("a",), d, k=-1),
            "digest": mod.GatherReq(("a",), np.ones((2, CH)), k=1),
            "views": mod.GatherReq(("a",), d, k=1, views=(pmod.FULL,) * 2),
            "key": mod.GatherReq(("a", "zz"), d, k=1),
            "channels": mod.GatherReq(("a",), np.ones(CH + 1), k=1),
            "view": mod.GatherReq(("a",), d, k=1, score_view=dataclasses.replace(
                pmod.SCORE, r_e=7, name="bad")),
        }[bad]
        with pytest.raises((ValueError, KeyError)) as e:
            dev.submit([req])
        errs.append(e.type)
        assert dev.stats.dram_bytes_read == 0      # rejected before work
    assert errs[0] is errs[1]


# ---------------------------------------------------------------------------
# KVPagePool
# ---------------------------------------------------------------------------

def _pools(policy="lossless", n_pages=6, **kw):
    pols = {"paper": (tpaging.PAPER_POLICY, rpaging.PAPER_POLICY),
            "lossless": (tpaging.LOSSLESS_POLICY, rpaging.LOSSLESS_POLICY)}
    budget = 2 * 8 * CH * 2                       # two pages stay resident
    tpool = tpaging.KVPagePool("trace", 8, budget, pols[policy][0],
                               device="cpu", **kw)
    rpool = rpaging.KVPagePool("trace", 8, budget, pols[policy][1],
                               sanitize=True, **kw)
    kv = synth.kv_cache(8 * n_pages, CH, seed=5)
    for pool in (tpool, rpool):
        pool.append_pages([(0, "k", i * 8, kv[i * 8:(i + 1) * 8], float(i))
                           for i in range(n_pages)])
        pool.spill_events = []
    return tpool, rpool


@pytest.mark.parametrize("policy", ["paper", "lossless"])
def test_pool_gather_identical_to_reference(policy):
    tpool, rpool = _pools(policy)
    digest = np.linspace(0, 1, CH).astype(np.float32)
    out = []
    for pool in (tpool, rpool):
        w1, d1 = pool.gather_topk(digest, 2)
        views = {p.key: p.gather_view.name for p in pool.iter_pages()
                 if p.resident is None}
        # churn the ranking: frozen winner views must not move
        pool.update_importance({p.key: 100.0 - i for i, p in
                                enumerate(pool.iter_pages())})
        cands, ticket = pool.gather_topk_async(digest, 3)
        w2, d2 = pool.drain_gather(cands, ticket)
        w3, d3 = pool.gather_topk(digest, 99)
        assert {p.key: p.gather_view.name for p in pool.iter_pages()
                if p.key in views} == views
        out.append(([p.key for p in w1 + w2 + w3], d1 + d2 + d3, views))
    (tk, td, tv), (rk, rd, rv) = out
    assert tk == rk and tv == rv and len(tk) == 2 + 3 + 4
    for a, b in zip(td, rd, strict=True):
        np.testing.assert_array_equal(a, b)
    assert tpool.page_traffic.keys() == rpool.page_traffic.keys()
    for key, t in tpool.page_traffic.items():
        assert vars(t) == vars(rpool.page_traffic[key])
    assert tpool.pages_gathered == 9 and tpool.pages_read == 0
    # covering k reads back what classic readback reads
    spilled = [p for p in tpool.iter_pages() if p.resident is None]
    base = dict(zip((p.key for p in spilled), tpool.read_pages(spilled)))
    for p, d in zip(w3, td[5:]):
        if p.gather_view.name == "bf16":
            np.testing.assert_array_equal(d, base[p.key])


def test_pool_gather_no_spilled_candidates():
    pool = tpaging.KVPagePool("trace", 8, 1 << 20, tpaging.LOSSLESS_POLICY,
                              device="cpu")
    pool.append_pages([(0, "k", 0, synth.kv_cache(8, CH, seed=6), 0.0)])
    assert pool.gather_topk(np.ones(CH, np.float32), 4) == ([], [])
    cands, ticket = pool.gather_topk_async(np.ones(CH, np.float32), 4)
    assert cands == [] and ticket is None
    assert pool.drain_gather(cands, ticket) == ([], [])


def test_update_importance_unknown_keys_counted():
    tpool, rpool = _pools()
    for pool in (tpool, rpool):
        known = pool.iter_pages()[0].key
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            pool.update_importance({known: 1.0, "ghost": 2.0})
            pool.update_importance({"phantom": 3.0, known: 0.5})
            pool.update_importance({"ghost": 1.0})
        assert pool.unknown_importance_keys == 3
        assert len(w) == 1                        # warn once, then count
        assert pool.iter_pages()[0].importance == 0.5
    assert [(p.key, p.importance, p.resident is None)
            for p in tpool.iter_pages()] == \
        [(p.key, p.importance, p.resident is None)
         for p in rpool.iter_pages()]


# ---------------------------------------------------------------------------
# ServeEngine (model forward)
# ---------------------------------------------------------------------------

ENGINE = dict(max_seq=96, batch=1, page_tokens=16, hbm_kv_budget=1 << 12)


@pytest.fixture(scope="module")
def models(smoke_model):
    rcfg, rparams = smoke_model("qwen2-0.5b")
    tcfg = smoke_config(ARCHS["qwen2-0.5b"])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.mark.slow
@pytest.mark.parametrize("async_io,shards,batch", [
    pytest.param(a, s, 1, id=f"{s}-{a}") for s in (1, 4)
    for a in (False, True)] + [
    pytest.param(False, 1, 2, id="1-False-batch2"),
    pytest.param(True, 4, 2, id="4-True-batch2")])
def test_pnm_covering_k_decodes_identical(models, async_io, shards, batch):
    """pnm_topk covering the spill reads back exactly what classic
    readback does: identical greedy tokens, on 1 and on 4 shards, at batch
    1 and 2."""
    _, _, tcfg, tparams = models
    prompt = (np.arange(48 * batch, dtype=np.int32).reshape(batch, 48)
              * 3) % tcfg.vocab
    runs = []
    for pnm in (None, 1_000):
        dev = ttier.make_device("trace", shards=shards, sanitize=True,
                                device="cpu")
        eng = TServe(tcfg, tparams, device_kind=dev, async_io=async_io,
                     pnm_topk=pnm, policy=tpaging.PAPER_POLICY,
                     device="cpu", **dict(ENGINE, batch=batch))
        runs.append((eng.generate(prompt, 10), eng))
    (t_base, e_base), (t_pnm, e_pnm) = runs
    np.testing.assert_array_equal(t_base, t_pnm)
    assert e_pnm.stats().tier_device_compute_s > 0
    assert e_pnm.pool.pages_gathered == e_base.pool.pages_read > 0


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("pos", [40, 48, 70])
def test_digest_and_attention_masses_on_the_same_cache(models, batch, pos):
    """The port's query digest and attention masses against the
    reference's on one cache array (the same bf16 bits in both engines):
    the tier and importance logic apart from the two models' rounding."""
    rcfg, rparams, tcfg, tparams = models
    kw = dict(ENGINE, batch=batch, pnm_topk=2, importance="attention")
    teng = TServe(tcfg, tparams, device="cpu", **kw)
    reng = RServe(rcfg, rparams, **kw)
    rng = np.random.default_rng(pos + batch)
    for kind in ("k", "v"):
        shape = tuple(teng.cache["layers"][kind].shape)
        x = (rng.standard_normal(shape) * 0.7).astype(np.float32)
        teng.cache["layers"][kind] = torch.from_numpy(x).to(torch.bfloat16)
        reng.cache["layers"][kind] = jax.numpy.asarray(
            x, dtype=reng.cache["layers"][kind].dtype)
    assert np.array_equal(
        teng.cache["layers"]["k"].float().numpy(),
        np.asarray(reng.cache["layers"]["k"], np.float32))
    teng.pos = reng.pos = pos
    for kind in ("k", "v"):
        np.testing.assert_allclose(teng._digest(kind).numpy(),
                                   reng._query_digest(kind), rtol=1e-5,
                                   atol=1e-6)
    got, want = teng._attention_masses(), reng._attention_masses()
    assert sorted(got) == sorted(want)
    for key, m in got.items():
        assert m == pytest.approx(want[key], rel=1e-4, abs=1e-7)


def _score_view_shift(tdev, rdev, keys, digest) -> np.ndarray:
    """Per page: the largest row's sum of |digest_c| * |q_t - q_r| where
    q_t, q_r are the two engines' values at the score view (sign and
    exponent, mantissa truncated) — how far the engines' stored KV alone
    moves the page's score.

    First the two stored pages must agree element by element within 4
    bf16 ulps of the page's largest value, the two models' bf16 rounding
    (up to 2.9 ulps on these requests): a fault in the stored KV fails
    here instead of widening the score tolerance."""
    def pages(recs):
        for rec in recs:
            u = np.asarray(rec.data, np.uint16).reshape(-1, digest.size)
            yield (u.astype(np.uint32) << 16).view(np.float32)

    def score_view(x):
        return (x.view(np.uint32) & np.uint32(0xFF800000)).view(np.float32)

    reads = [(ttier.ReadReq(k, kind=ttier.KV, view=tprec.FULL),
              rtier.ReadReq(k, kind=rtier.KV, view=rprec.FULL))
             for k in keys]
    mine = pages(tdev.submit([t for t, _ in reads]))
    theirs = pages(rdev.submit([r for _, r in reads]))
    shift = []
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=4 * 2.0 ** -8 * float(np.abs(b).max()))
        dq = np.abs(score_view(a) - score_view(b))
        shift.append(float((dq * np.abs(digest)).sum(1).max()))
    return np.asarray(shift)


def _recording(dev):
    """Wrap a tier's ``submit`` to keep every gather and its receipt."""
    log = []
    submit = dev.submit

    def recorded(reqs):
        recs = submit(reqs)
        log.extend((q, r) for q, r in zip(reqs, recs) if r.op == "gather")
        return recs
    dev.submit = recorded
    return log


def _forced(eng, toks, n_prompt):
    logits = [eng.prefill(toks[:, :n_prompt])]
    for t in range(n_prompt, toks.shape[1]):
        logits.append(eng.decode(toks[:, t:t + 1]))
    return np.stack([np.asarray(x, np.float32) for x in logits], 1)


@pytest.mark.slow
@pytest.mark.parametrize("batch", [pytest.param(1, id="batch1"),
                                   pytest.param(2, id="batch2")])
def test_pnm_attention_importance_tracks_reference_engine(models, batch):
    """Bounded pnm_topk with importance="attention" against the JAX
    engine fed the same weights and tokens, at batch 1 and 2.  The two
    models' KV differs by bf16 rounding, so scores agree to a bf16
    tolerance (4 ulps of the page's largest score); winners must agree
    wherever the reference's k-th and (k+1)-th scores are further apart
    than the two pages' tolerances, and the logits pass the margin-aware
    bound of tests/test_kv_dtype.py.

    The score view keeps sign and exponent only (truncated), so a KV value
    a few bf16 ulps from a power of two may truncate to another exponent
    in one engine than in the other.  At batch 2 (twice the rows a page)
    that moves scores past the bf16 tolerance, so there a page's
    tolerance adds the shift the two engines' stored pages make at the
    score view (``_score_view_shift``, which first holds the stored pages
    to each other within 4 bf16 ulps of the page's largest value); the
    logic itself is held on one cache array by
    test_digest_and_attention_masses_on_the_same_cache."""
    rcfg, rparams, tcfg, tparams = models
    kw = dict(ENGINE, async_io=False, pnm_topk=2, importance="attention",
              batch=batch)
    tdev = ttier.make_device("trace", shards=1, device="cpu")
    rdev = rtier.make_device("trace", shards=1)
    tlog, rlog = _recording(tdev), _recording(rdev)
    teng = TServe(tcfg, tparams, device_kind=tdev, device="cpu", **kw)
    reng = RServe(rcfg, rparams, device_kind=rdev, **kw)
    toks = (np.arange(88 * batch, dtype=np.int32).reshape(batch, 88)
            * 7) % tcfg.vocab
    got = _forced(teng, toks, 48)
    ref = _forced(reng, toks, 48)
    assert len(tlog) == len(rlog) >= 4
    compared = 0
    for (tq, tr), (rq, rr) in zip(tlog, rlog):
        assert tq.keys == rq.keys
        assert [v.name for v in tq.views] == [v.name for v in rq.views]
        tol = 4 * 2.0 ** -8 * float(np.abs(rr.gather.scores).max())
        if batch == 1:
            np.testing.assert_allclose(tr.gather.scores, rr.gather.scores,
                                       atol=tol, rtol=0)
        else:   # a tolerance per page
            tol = tol + _score_view_shift(tdev, rdev, rq.keys, rq.digest)
            diff = np.abs(tr.gather.scores - rr.gather.scores)
            assert (diff <= tol).all(), (diff, tol)
        tol = np.broadcast_to(tol, rr.gather.scores.shape)
        order = np.argsort(-rr.gather.scores, kind="stable")
        if len(order) > 2 and (rr.gather.scores[order[1]]
                               - rr.gather.scores[order[2]]
                               > tol[order[1]] + tol[order[2]]):
            assert tr.gather.keys == rr.gather.keys
            compared += 1
    assert compared > 0
    assert teng._imp_acc.keys() == reng._imp_acc.keys()
    for key, m in reng._imp_acc.items():
        assert teng._imp_acc[key] == pytest.approx(m, rel=0.05, abs=1e-3)
    assert teng.pool.unknown_importance_keys == 0
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    assert rms < 0.5 * float(np.median(margin)), (rms, np.median(margin))
    assert agree[margin > 4.0 * rms].all()
    assert teng.stats().spilled_pages == reng.stats().spilled_pages > 2


@pytest.mark.slow
def test_engine_pnm_args_and_serve_entry_point(models, capsys):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError):
        TServe(tcfg, tparams, device="cpu", importance="nonsense", **ENGINE)
    with pytest.raises(ValueError):
        TServe(tcfg, tparams, device="cpu", pnm_topk=-1, **ENGINE)
    common = dict(smoke=True, prompt_len=48, n_tokens=6, requests=1,
                  hbm_kv_budget=1 << 12, page_tokens=16, torch_device="cpu",
                  params=tparams)
    base = serve(**common)
    pnm = serve(pnm_topk=1, importance="attention", shards=2, **common)
    assert pnm.gathered_pages > 0 and pnm.readback_pages == 0
    assert pnm.tier_link_out < base.tier_link_out
    assert pnm.tokens[0].shape == (1, 6)
    out = capsys.readouterr().out
    assert "PNM read mode" in out and "fleet: 2 tier devices" in out


def _truncated_gather_run(mod, pmod):
    """Gathers over pages whose blocks were truncated to MAN4 (so score
    and winner reads are served at the intersected views, ``cut11`` for
    a (r_m 2, d_m 4) winner view) and over a partial page flushed by its
    write, with special values in the pages."""
    kv = synth.kv_cache(ROWS * 5, CH, seed=12)
    kv[::7, 3] = 0x407F                  # MAN4's round carries into exp
    kv[::5, 4] = 0x7F81                  # NaN, payload in dropped planes
    kv[::9, 5] = 0xFF80                  # -Inf
    dev = mod.TierStore("bitplane-kv", kv_window=ROWS, sanitize=True,
                        **({"device": "cpu"} if mod is ttier else {}))
    keys = ("a", "b", "c", "d", "part")
    dev.submit([mod.WriteReq(k, kv[i * ROWS:(i + 1) * ROWS], kind=mod.KV)
                for i, k in enumerate(keys[:4])]
               + [mod.WriteReq("part", kv[4 * ROWS:4 * ROWS + 11],
                               kind=mod.KV)])
    dev.truncate_planes(["b", "c"], pmod.MAN4)
    wide = pmod.PrecisionView(r_m=2, d_m=4, name="wide")
    views = (pmod.FULL, wide, pmod.MAN0, pmod.MAN4, wide)
    d = np.sin(np.arange(CH)).astype(np.float32)
    return dev.submit([mod.GatherReq(keys, d, k=5, views=views),
                       mod.GatherReq(keys, d, k=2),
                       mod.GatherReq(keys, d, k=5, score_view=pmod.MAN0)])


def test_gather_over_truncated_and_partial_pages_identical_to_reference():
    trecs = _truncated_gather_run(ttier, tprec)
    rrecs = _truncated_gather_run(rtier, rprec)
    same_receipts(trecs, rrecs)
    assert sorted(trecs[0].gather.keys) == ["a", "b", "c", "d", "part"]
    part = trecs[0].gather.data[trecs[0].gather.keys.index("part")]
    assert part.shape == (11, CH)
