"""Port vs reference: shared-prefix KV reuse and the reclaim ladder.

* chain hashes and shared keys equal the reference's as strings;
* the tier's refcounts (acquire / release / delete, truncation refused on
  a co-owned key, random interleavings), the fleet's routing of shared
  pages and the sanitizer's refcount checks run the same script through
  both packages with identical results;
* pools wired to a ``PrefixShareIndex`` — sharing spilled pages, and
  reclaiming private pages while never degrading shared ones — are
  byte-identical to the reference's pools fed the same pages: stored
  payloads, ledger, receipts, freed bytes and readback after truncation;
* the KV-per-token slope equals the reference's (full and smoke
  qwen2-0.5b, bf16 and fp8 caches);
* at the scheduler, a shared prefix unblocks admission and copy-on-write
  divergence keeps every request's tokens equal to its solo run, with the
  tier empty afterwards.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import precision as rprec  # noqa: E402
from repro.core import sharding as rshard  # noqa: E402
from repro.core import synth  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro.runtime import serving as rserving  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import sharding as tshard  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from test_torch_tier import _same_device, _same_receipts  # noqa: E402

PORT = dict(tier=ttier, prec=tprec, shard=tshard, paging=tpaging, kw={"device": "cpu"})
REF = dict(tier=rtier, prec=rprec, shard=rshard, paging=rpaging, kw={})


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _payload(seed=0, shape=(64, 256)):
    return np.random.default_rng(seed).integers(
        0, 1 << 16, size=shape, dtype=np.uint16)


def _both(fn):
    """Run ``fn(pkg)`` for the port and the reference → (port, ref)."""
    return fn(PORT), fn(REF)


# ---------------------------------------------------------------------------
# chain hashing and keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,page", [((1, 50), 16), ((2, 64), 16),
                                        ((1, 200), 64), ((1, 15), 16)])
def test_chain_hashes_and_keys_equal_reference(shape, page):
    toks = np.random.default_rng(0).integers(0, 1000, shape).astype(np.int32)
    got = tpaging.prefix_chain_hashes(toks, page)
    assert got == rpaging.prefix_chain_hashes(toks, page)
    assert len(got) == shape[1] // page and len(set(got)) == len(got)
    diverged = toks.copy()
    diverged[..., min(20, shape[1] - 1)] += 1
    assert tpaging.prefix_chain_hashes(diverged, page) == \
        rpaging.prefix_chain_hashes(diverged, page)
    for h in got[:2]:
        assert tpaging.shared_page_key(h, 3, "v") == \
            rpaging.shared_page_key(h, 3, "v") == f"shared.{h}.L3.v"
    assert tpaging.DEFAULT_DEGRADE_LADDER == tuple(
        tprec.VIEWS[v.name] for v in rpaging.DEFAULT_DEGRADE_LADDER)


# ---------------------------------------------------------------------------
# tier refcounts: the same script through both packages
# ---------------------------------------------------------------------------

def _refcount_script(pkg):
    T = pkg["tier"]
    dev = T.make_device("trace", sanitize=True, kv_window=16, **pkg["kw"])
    kv = synth.kv_cache(16, 64, seed=0)
    out = [dev.submit([T.WriteReq("shared.h0.L0.k", kv, kind=T.KV)])]
    one_copy = dev.resident_bytes()
    out.append([dev.acquire("shared.h0.L0.k"), dev.acquire("shared.h0.L0.k"),
                dev.resident_bytes() == one_copy,
                dev.release("shared.h0.L0.k"), dev.release("shared.h0.L0.k"),
                dev.resident_bytes() == one_copy,
                dev.release("shared.h0.L0.k"), dev.resident_bytes(),
                dev.stats.blocks, dev.refcount("shared.h0.L0.k")])
    with pytest.raises(KeyError):
        dev.acquire("ghost")
    # delete on a shared key drops one reference, not the bytes
    dev.submit([T.WriteReq("s", _payload(1))])
    dev.acquire("s")
    dev.delete("s")
    out.append([dev.refcount("s")])
    out.append(dev.submit([T.ReadReq("s")]))
    dev.delete("s")
    with pytest.raises(KeyError):
        dev.release("s")                      # double release is a bug
    # delete_prefix spares co-owned survivors
    dev.submit([T.WriteReq("shared.h.L0.k", synth.kv_cache(16, 64, seed=2),
                           kind=T.KV),
                T.WriteReq("shared.h.L1.k", synth.kv_cache(16, 64, seed=3),
                           kind=T.KV)])
    dev.acquire("shared.h.L0.k")
    out.append([dev.delete_prefix("shared."), dev.refcount("shared.h.L0.k"),
                dev.refcount("shared.h.L1.k"), dev.resident_bytes(),
                dev.delete_prefix("shared."), dev.resident_bytes()])
    # truncation refused on a co-owned key, acquire refused once truncated
    dev.submit([T.WriteReq("s.p", synth.kv_cache(16, 64, seed=4), kind=T.KV)])
    dev.acquire("s.p")
    with pytest.raises(ValueError):
        dev.truncate_planes(["s.p"], pkg["prec"].MAN4)
    dev.release("s.p")
    out.append([dev.truncate_planes(["s.p"], pkg["prec"].MAN4)])
    with pytest.raises(ValueError):
        dev.acquire("s.p")
    dev.delete("s.p")
    out.append([dev.resident_bytes(), dev.stats.blocks])
    return dev, out


def test_refcounts_identical_to_reference():
    (td, tout), (rd, rout) = _both(_refcount_script)
    for a, b in zip(tout, rout, strict=True):
        if a and hasattr(a[0], "key"):
            _same_receipts(a, b)
        else:
            assert a == b
    assert tout[1][-3:] == [0, 0, 0] and tout[-2][0] > 0
    _same_device(td, rd)


def _interleavings(pkg, seed):
    T = pkg["tier"]
    rng = np.random.default_rng(seed)
    dev = T.make_device("trace", sanitize=True, kv_window=16, **pkg["kw"])
    refs, log = {}, []
    for _ in range(200):
        op = rng.integers(0, 8)
        key = f"shared.h{rng.integers(0, 5)}.L0.k"
        if op < 3:
            if key not in refs:
                dev.submit([T.WriteReq(key, synth.kv_cache(
                    16, 64, seed=int(rng.integers(1 << 16))), kind=T.KV)])
                refs[key] = 1
        elif op < 5 and key in refs:
            refs[key] += 1
            log.append(dev.acquire(key))
        elif op < 7 and key in refs:
            refs[key] -= 1
            log.append(dev.release(key))
            if refs[key] == 0:
                del refs[key]
        elif refs:
            log.append(dev.delete_prefix("shared."))
            refs = {k: n - 1 for k, n in refs.items() if n > 1}
        assert {k: dev.refcount(k) for k in refs} == refs
        log.append(dev.resident_bytes())
    for k in sorted(refs):
        while dev.refcount(k):
            dev.release(k)
    assert dev.resident_bytes() == 0 and dev.stats.blocks == 0
    return dev, log


@pytest.mark.parametrize("seed", [13, 14])
def test_random_refcount_interleavings_identical(seed):
    (td, tlog), (rd, rlog) = _both(lambda p: _interleavings(p, seed))
    assert tlog == rlog
    _same_device(td, rd)


# ---------------------------------------------------------------------------
# fleets: shared pages colocate, refcounts stay on the owning shard
# ---------------------------------------------------------------------------

def _fleet_script(pkg):
    T, S = pkg["tier"], pkg["shard"]
    P = pkg["paging"]
    fleet = S.ShardedTierStore(4, kind="trace", kv_window=16, sanitize=True,
                               **pkg["kw"])
    chain = [P.shared_page_key("abcd", layer, kind)
             for layer in range(4) for kind in ("k", "v")]
    owners = [fleet.owner(k) for k in chain]
    spread = sorted({fleet.owner(P.shared_page_key(f"h{i:04x}", 0, "k"))
                     for i in range(32)})
    key = P.shared_page_key("feed", 0, "k")
    recs = fleet.submit([T.WriteReq(key, synth.kv_cache(16, 64, seed=8),
                                    kind=T.KV)])
    owner = fleet.owner(key)
    out = [owners, spread, fleet.acquire(key), fleet.acquire(key)]
    one_copy = fleet.resident_bytes("")
    out += [fleet.delete_prefix("shared"), fleet.refcount(key),
            [s.refcount(key) for s in fleet.shards],
            [s.resident_bytes("shared") for s in fleet.shards],
            fleet.resident_bytes("") == one_copy]
    with pytest.raises(ValueError):
        fleet.truncate_planes([key], pkg["prec"].MAN4)   # co-owned: refused
    out += [[len(b.payloads[0]) for s in fleet.shards
             for b in s._tensors.get(key, ())]]
    out += [fleet.delete_prefix("shared"), fleet.delete_prefix("shared"),
            fleet.resident_bytes("")]
    # the index routes references through the fleet to the owning shard
    idx = P.PrefixShareIndex(fleet)
    key = P.shared_page_key("cafe", 2, "v")
    recs += fleet.submit([T.WriteReq(key, synth.kv_cache(16, 64, seed=9),
                                     kind=T.KV)])
    idx.register("cafe", 2, "v", key)
    out += [idx.acquire("cafe", 2, "v"),
            fleet.shards[fleet.owner(key)].refcount(key),
            idx.acquire("missing", 0, "k"), idx.resident_chain(["cafe", "x"]),
            idx.release(key), idx.release(key), idx.acquire("cafe", 2, "v"),
            fleet.resident_bytes(""), [s.stats.blocks for s in fleet.shards],
            fleet.compression_ratio(""), fleet.layout.plane_aligned,
            owner]
    # a private key truncates on its home shard
    recs += fleet.submit([T.WriteReq("r0.p", synth.kv_cache(16, 64, seed=5),
                                     kind=T.KV)])
    out += [fleet.truncate_planes(["r0.p"], pkg["prec"].MAN0),
            [dataclasses.asdict(d) for d in fleet.per_device_stats()]]
    return fleet, recs, out


def test_fleet_shared_pages_identical_to_reference():
    (tf, trecs, tout), (rf, rrecs, rout) = _both(_fleet_script)
    assert tout == rout
    owners, spread = tout[0], tout[1]
    assert len(set(owners)) == 1 and len(spread) > 1   # colocate, spread
    assert tout[5] == 2 and sum(tout[6]) == 2          # one ref dropped,
    assert tout[-2] > 0                                # on one shard
    _same_receipts(trecs, rrecs)
    for ts, rs in zip(tf.shards, rf.shards, strict=True):
        _same_device(ts, rs)


# ---------------------------------------------------------------------------
# sanitizer: refcount fault injection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refs", [5, 0])
def test_corrupt_refcount_trips_sanitizer(refs):
    for pkg in (PORT, REF):
        T = pkg["tier"]
        kw = dict(pkg["kw"]) or {"shards": 1}
        dev = T.make_device("trace", sanitize=True, **kw)
        dev.submit([T.WriteReq("k0", _payload(0))])
        dev.acquire("k0")
        dev._ledger["k0"].refs = refs
        with pytest.raises(T.SanitizerViolation) as ei:
            dev.submit([T.ReadReq("k0")])
        assert ei.value.invariant == "refcount-conservation"
        assert ei.value.key == "k0" and ei.value.actual == refs


# ---------------------------------------------------------------------------
# pools: spill-time sharing and the reclaim ladder, byte-identical
# ---------------------------------------------------------------------------

def _kv_pages(n, seed0=40):
    return [(0, "k", 16 * i, synth.kv_cache(16, 64, seed=seed0 + i),
             float(i), f"h{i}") for i in range(n)]


def _pool(pkg, dev, i, idx=None, ladder=(), policy="LOSSLESS_POLICY"):
    P = pkg["paging"]
    kw = {"tier": dev} if pkg is PORT else {"device": dev}
    return P.KVPagePool(page_tokens=16, hbm_budget_bytes=0,
                        policy=getattr(P, policy), key_prefix=f"r{i}.",
                        degrade_ladder=ladder, prefix_index=idx, **kw)


def _pool_tier(pool):
    return pool.tier if hasattr(pool, "tier") else pool.device


def _share_script(pkg):
    T, P = pkg["tier"], pkg["paging"]
    dev = T.make_device("trace", sanitize=True, kv_window=16, **pkg["kw"])
    idx = P.PrefixShareIndex(dev)
    pools = [_pool(pkg, dev, i, idx) for i in range(3)]
    for pool in pools:
        pool.append_pages(_kv_pages(2))
    one_copy = dev.resident_bytes("shared.")
    out = [one_copy, dev.resident_bytes(),
           [dev.refcount(P.shared_page_key(f"h{i}", 0, "k")) for i in range(2)],
           [pool.read_layer(0, "k") for pool in pools]]
    solo = _pool(pkg, T.make_device("trace", kv_window=16, **pkg["kw"]), 0)
    solo.append_pages([e[:5] for e in _kv_pages(2)])
    out.append(solo.read_layer(0, "k"))
    out.append([pools[0].release(), pools[1].release(),
                dev.resident_bytes("shared.") == one_copy,
                pools[2].release(), dev.resident_bytes(), dev.stats.blocks])
    traffic = [{k: vars(t) for k, t in p.page_traffic.items()} for p in pools]
    return dev, out, traffic


def _same_outputs(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_outputs(x, y)
    else:
        assert a == b


def test_pools_share_spilled_pages_one_stored_copy_identical():
    (td, tout, ttraffic), (rd, rout, rtraffic) = _both(_share_script)
    _same_outputs(tout, rout)
    assert ttraffic == rtraffic
    one_copy, total, refs, reads, want, rel = tout
    assert one_copy > 0 and total == one_copy and refs == [3, 3]
    for got in reads:                      # every pool reads the solo bytes
        np.testing.assert_array_equal(got, want)
    assert rel[2] and rel[-2:] == [0, 0]
    _same_device(td, rd)


def _reclaim_script(pkg):
    T, P = pkg["tier"], pkg["paging"]
    dev = T.make_device("trace", sanitize=True, kv_window=16, **pkg["kw"])
    idx = P.PrefixShareIndex(dev)
    ladder = P.DEFAULT_DEGRADE_LADDER
    a, b = _pool(pkg, dev, 0, idx, ladder), _pool(pkg, dev, 1, idx, ladder)
    a.append_pages(_kv_pages(2))              # shared head windows
    a.append_pages([(0, "k", 32 + 16 * i,
                     synth.kv_cache(16, 64, seed=60 + i), 10.0 + i)
                    for i in range(2)])       # private tail
    b.append_pages(_kv_pages(2))
    shared_before = dev.resident_bytes("shared.")
    out = [shared_before, a.reclaim(100), a.reclaim(1 << 30),
           dev.resident_bytes("shared.") == shared_before,
           idx.resident_chain(["h0", "h1"]),
           [p.degrade_level for p in a.iter_pages()],
           a.read_layer(0, "k")]
    snap = {k: [list(bl.payloads) for bl in v] for k, v in dev._tensors.items()}
    b.release()
    out += [a.reclaim(1 << 30), dev.resident_bytes("shared.") == shared_before]
    c = _pool(pkg, dev, 2, idx, ladder)
    c.append_pages(_kv_pages(2))              # acquires, does not re-write
    out += [dev.refcount(P.shared_page_key("h0", 0, "k")),
            c.read_layer(0, "k"), a.release(), c.release(),
            dev.resident_bytes()]
    # without a ladder (the pool default) reclaim touches nothing
    d = _pool(pkg, dev, 3)
    d.append_pages([e[:5] for e in _kv_pages(2)])
    out += [d.reclaim(1 << 30), d.reclaim(1 << 30, ladder=(pkg["prec"].MAN0,))]
    d.release()
    return dev, out, snap


def test_reclaim_never_degrades_shared_pages_identical():
    (td, tout, tsnap), (rd, rout, rsnap) = _both(_reclaim_script)
    _same_outputs(tout, rout)
    assert tsnap == rsnap                     # payloads after truncation
    shared_before, part, rest, kept, chain = tout[:5]
    assert 0 < part and rest > 0 and kept and chain == 2
    assert tout[5] == [-1, -1, 2, 2]          # private pages at the last rung
    assert tout[7] == 0 and tout[8]           # sole referer: still pristine
    assert tout[9] == 2 and tout[-3] == 0
    assert tout[-2] == 0 and tout[-1] > 0     # no ladder: nothing shed
    _same_device(td, rd)


def test_index_tier_mismatch_rejected():
    idx = tpaging.PrefixShareIndex(ttier.make_device("trace", device="cpu"))
    with pytest.raises(ValueError):
        tpaging.KVPagePool(ttier.make_device("trace", device="cpu"),
                           prefix_index=idx)


# ---------------------------------------------------------------------------
# the admission slope: from the config, equal to the reference's
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_slope_cache():
    """Leave the reference's process-wide ``_kv_bytes_per_token_b1``
    cache (``lru_cache(maxsize=32)``) as empty as this test found it in a
    fresh process: ``tests/test_prefix_share.py`` bounds its size, and
    xdist may run that file after this one in the same worker."""
    yield
    rserving._kv_bytes_per_token_b1.cache_clear()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
def test_kv_per_token_slope_equals_reference(smoke, kv_dtype,
                                             ref_slope_cache):
    from repro.configs import ARCHS as RARCHS, smoke_config as rsmoke

    tcfg, rcfg = ARCHS["qwen2-0.5b"], RARCHS["qwen2-0.5b"]
    if smoke:
        tcfg, rcfg = smoke_config(tcfg), rsmoke(rcfg)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    rcfg = dataclasses.replace(rcfg, kv_dtype=kv_dtype)
    got = tserving._kv_bytes_per_token_b1(tcfg)
    assert got == rserving._kv_bytes_per_token_b1(rcfg)
    assert got == tserving._kv_bytes_per_token_b1(
        dataclasses.replace(tcfg, kv_dtype="bfloat16"))   # 2 B, any dtype
    if not smoke:
        assert got == 24 * 2 * 2 * 64 * 2
        assert tserving.projected_kv_bytes(tcfg, 1, 512 + 64, 64) == 7_077_888
    for b in (2, 3, 1024):
        assert tserving._kv_bytes_per_token(tcfg, b) == got * b
        assert tserving.projected_kv_bytes(tcfg, b, 100, 16) == \
            rserving.projected_kv_bytes(rcfg, b, 100, 16)
    info = tserving._kv_bytes_per_token_b1.cache_info()
    assert info.maxsize == 32


# ---------------------------------------------------------------------------
# model-backed: the admission discount and copy-on-write divergence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(smoke_model):
    rcfg, rparams = smoke_model("qwen2-0.5b")
    tcfg = smoke_config(ARCHS["qwen2-0.5b"])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return tcfg, tparams


def _solo(cfg, params, sched, req):
    return tserving.ServeEngine(
        cfg, params, max_seq=sched.max_seq, batch=1, page_tokens=16,
        hbm_kv_budget=1 << 12, device_kind="trace",
        policy=tpaging.LOSSLESS_POLICY, device="cpu",
    ).generate(req.prompt, req.max_new_tokens, seed=req.seed)


def _sched(cfg, params, **kw):
    return tserving.ServeScheduler(
        cfg, params, max_batch=3, device_kind="trace",
        policy=tpaging.LOSSLESS_POLICY, page_tokens=16,
        hbm_kv_budget=1 << 12, device="cpu", **kw)


def test_shared_prefix_unblocks_admission(models):
    cfg, params = models
    proj = tserving.projected_kv_bytes(cfg, 1, 32 + 5, 16)
    prompt = np.random.default_rng(21).integers(
        0, cfg.vocab, (1, 32)).astype(np.int32)
    reqs = lambda: [tserving.ServeRequest(  # noqa: E731
        req_id=i, arrival=0.0, prompt=prompt.copy(), max_new_tokens=5,
        seed=100 + i) for i in range(3)]
    cap = int(1.5 * proj)
    assert _sched(cfg, params, kv_capacity_bytes=cap).run(
        reqs()).peak_active == 1              # capacity serializes
    sched = _sched(cfg, params, kv_capacity_bytes=cap, prefix_share=True)
    rep = sched.run(reqs())
    assert rep.peak_active >= 2               # followers charged novel only
    recs = sorted(rep.records, key=lambda r: r.admit_step)
    assert recs[0].kv_novel_bytes == recs[0].kv_projected_bytes
    assert any(r.kv_novel_bytes < r.kv_projected_bytes for r in recs[1:])
    for req, rec in zip(reqs(), rep.records):
        np.testing.assert_array_equal(_solo(cfg, params, sched, req),
                                      rec.tokens)
    assert sched.tier.resident_bytes("") == 0
    assert sched.kv_committed_bytes == 0


@pytest.mark.parametrize("shards", [1, 2])
def test_cow_divergence_bit_identical(models, shards):
    cfg, params = models
    rng = np.random.default_rng(23)
    head = rng.integers(0, cfg.vocab, (1, 32)).astype(np.int32)
    prompts = [np.concatenate(
        [head, rng.integers(0, cfg.vocab, (1, 16)).astype(np.int32)],
        axis=1) for _ in range(3)]
    reqs = [tserving.ServeRequest(req_id=i, arrival=0.0, prompt=p,
                                  max_new_tokens=4, seed=300 + i)
            for i, p in enumerate(prompts)]
    sched = _sched(cfg, params, prefix_share=True, shards=shards)
    sched.submit(reqs)
    stores = getattr(sched.tier, "shards", [sched.tier])
    peak_refs = 0
    while sched.step():
        for s in stores:
            for k, e in s._ledger.items():
                if k.startswith("shared."):
                    peak_refs = max(peak_refs, e.refs)
    rep = sched.report()
    assert peak_refs == 3                     # head windows co-owned
    for req, rec in zip(reqs, rep.records):
        np.testing.assert_array_equal(_solo(cfg, params, sched, req),
                                      rec.tokens)
    assert sched.tier.resident_bytes("") == 0
    assert all(s.stats.blocks == 0 for s in stores)
    assert sched.kv_committed_bytes == 0
