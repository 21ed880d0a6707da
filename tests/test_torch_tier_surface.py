"""Port vs reference: the rest of the tier's surface, the pool's prefetch
and the engine's readback helpers, and the example twins.

* the per-block encoder (``TierStore(batched_encode=False)``): byte-
  identical to the batched one for every layout, sync and async
  (``test_encode_batch.py:66``), to the reference's per-block encoder,
  and slower than the batched one (``:177``);
* the legacy shims (``write_tensor`` / ``read_tensor`` / ``write_kv`` /
  ``read_kv`` / ``flush_kv``) and the stats surface (``pending``,
  ``busy_backlog_s``, ``n_blocks`` / ``footprint`` / ``logical_bytes``,
  ``DeviceStats.bypass_rate``, ``Receipt.dram_bytes`` / ``link_bytes``)
  on one device and a fleet, against the reference;
* pool prefetch (``test_tier_async.py:489-528``, the abandoned
  prefetch, ``test_prefix_share.py::
  test_read_after_reclaim_reflects_truncation_despite_prefetch``), and
  the pool's accounting helpers, against the reference's pool;
* ``ServeEngine.kv_through_tier`` / ``layer_traffic``: byte-identical to
  the reference's pool fed the engine's page stream, and the
  data-independent traffic equal to the reference engine's;
* each example twin at smoke width on the CPU, with what the reference
  example asserts.

Tolerance 0 for every byte, word and receipt.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import precision as rprec  # noqa: E402
from repro.core import sharding as rshard  # noqa: E402
from repro.core import synth  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import sharding as tshard  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402
from test_torch_pnm import same_receipts  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SUM_FIELDS = [f.name for f in dataclasses.fields(ttier.DeviceStats)]


# ---------------------------------------------------------------------------
# per-block encoder
# ---------------------------------------------------------------------------

def _mixed_write_batch(mod, kv_window):
    W, KV = mod.WriteReq, mod.KV
    return [
        W("w0", synth.weights(6_000, seed=0)),
        W("s0", synth.kv_cache(2 * kv_window, 64, seed=1), kind=KV),
        W("w1", synth.weights(2_048, seed=2)),
        W("s1", synth.kv_cache(kv_window, 32, seed=3), kind=KV),
        W("s0", synth.kv_cache(kv_window, 64, seed=4), kind=KV),
        W("part", synth.kv_cache(kv_window // 2, 32, seed=5), kind=KV,
          flush=False),
        # random (incompressible) payload exercises the bypass pre-screen
        W("rnd", np.random.default_rng(9).integers(
            0, 1 << 16, 4096).astype(np.uint16)),
    ]


def _storage_state(dev):
    out = {}
    for key, blocks in dev._tensors.items():
        out[key] = [
            (b.payloads, b.flags, b.valid_elems, b.padded_elems,
             None if b.kv_meta is None else
             (b.kv_meta.beta.tobytes(), b.kv_meta.n_tokens,
              b.kv_meta.n_channels))
            for b in blocks
        ]
    return out, dict(dev._shapes)


@pytest.mark.parametrize("layout", sorted(ttier.LAYOUTS))
def test_batched_encode_byte_identical_to_scalar(layout):
    kv_window = 16
    scalar = ttier.TierStore(layout=layout, kv_window=kv_window,
                             batched_encode=False, device="cpu")
    batched = ttier.TierStore(layout=layout, kv_window=kv_window,
                              batched_encode=True, device="cpu")
    ref = rtier.TierStore(layout=layout, kv_window=kv_window,
                          batched_encode=False)
    s_recs = scalar.submit(_mixed_write_batch(ttier, kv_window))
    b_recs = [t.wait() for t in batched.submit_async(
        _mixed_write_batch(ttier, kv_window))]
    r_recs = ref.submit(_mixed_write_batch(rtier, kv_window))
    assert _storage_state(scalar) == _storage_state(batched) == \
        _storage_state(ref)
    same_receipts(s_recs, r_recs)
    same_receipts(b_recs, r_recs)
    for f in SUM_FIELDS:
        assert getattr(scalar.stats, f) == getattr(batched.stats, f) == \
            getattr(ref.stats, f), f
    for key, kind in (("w0", ttier.TENSOR), ("s0", ttier.KV),
                      ("part", ttier.KV)):
        a, = scalar.submit([ttier.ReadReq(key, kind=kind)])
        b, = batched.submit([ttier.ReadReq(key, kind=kind)])
        np.testing.assert_array_equal(a.data, b.data)


def test_batched_encode_faster_than_scalar():
    data = [synth.kv_cache(32, 64, seed=200 + i) for i in range(24)]
    reqs = [ttier.WriteReq(f"p{i}", d, kind=ttier.KV)
            for i, d in enumerate(data)]

    def run(batched):
        best = float("inf")
        for _ in range(3):
            dev = ttier.TierStore(layout="bitplane-kv", kv_window=32,
                                  batched_encode=batched, device="cpu")
            t0 = time.perf_counter()
            dev.submit(reqs)
            best = min(best, time.perf_counter() - t0)
        return best

    t_scalar, t_batched = run(False), run(True)
    assert t_batched < t_scalar, (t_batched, t_scalar)


# ---------------------------------------------------------------------------
# legacy shims and the stats surface
# ---------------------------------------------------------------------------

def _shim_script(mod, pmod, dev):
    """Shims, async reads and introspection, returning what a caller
    sees."""
    w = synth.weights(5_000, seed=31)
    kv = synth.kv_cache(40, 64, seed=32)
    out = {}
    dev.write_tensor("w", w)
    dev.write_kv("s", kv[:24])              # one window commits, 8 staged
    out["staged_blocks"] = dev.n_blocks("s")
    dev.write_kv("s", kv[24:36])
    out["tensor"] = [dev.read_tensor("w"),
                     dev.read_tensor("w", pmod.VIEWS["man2"])]
    dev.flush_kv("s")                       # commits the staged tail
    tickets = dev.submit_async([mod.ReadReq("w", view=pmod.MAN4),
                                mod.ReadReq("s", kind=mod.KV)])
    out["pending"] = dev.pending
    out["backlog"] = dev.busy_backlog_s
    dev.flush_kv("w")                       # nothing staged: no-op
    out["queued_reads"] = dev.drain(tickets)
    out["kv"] = dev.read_kv("s")
    out["kv_man0"] = dev.read_kv("s", pmod.MAN0)
    dev.flush_kv("s")                       # nothing staged: no-op
    dev.write_kv("s", kv[36:])
    out["implicit"] = dev.read_kv("s")      # a read flushes the tail
    out["intro"] = [(dev.n_blocks(k), dev.footprint(k),
                     dev.logical_bytes(k)) for k in ("w", "s")]
    out["absent"] = dev.n_blocks("nope")
    out["bypass"] = dev.stats.bypass_rate
    out["ratio"] = dev.stats.compression_ratio
    dev.quiesce()
    out["idle"] = dev.busy_backlog_s
    out["stats"] = {f: getattr(dev.stats, f) for f in SUM_FIELDS}
    return out


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("kind", ["trace", "gcomp", "plain"])
def test_shims_and_stats_identical_to_reference(kind, shards):
    if shards:
        tdev = tshard.ShardedTierStore(shards, kind=kind, kv_window=16,
                                       device="cpu", sanitize=True)
        rdev = rshard.ShardedTierStore(shards, kind=kind, kv_window=16,
                                       sanitize=True)
    else:
        tdev = ttier.make_device(kind, kv_window=16, shards=1,
                                 device="cpu", sanitize=True)
        rdev = rtier.make_device(kind, kv_window=16, shards=1,
                                 sanitize=True)
    t = _shim_script(ttier, tprec, tdev)
    r = _shim_script(rtier, rprec, rdev)
    same_receipts(t.pop("queued_reads"), r.pop("queued_reads"))
    for key in ("tensor",):
        for a, b in zip(t.pop(key), r.pop(key), strict=True):
            np.testing.assert_array_equal(a, b)
    for key in ("kv", "kv_man0", "implicit"):
        np.testing.assert_array_equal(t.pop(key), r.pop(key))
    assert t == r
    assert t["pending"] == 2 and t["idle"] == 0.0
    if kind == "trace":     # 16-token windows: 2 full, 2 flushed tails
        assert t["staged_blocks"] == 1 and t["intro"][1][0] == 4


def test_flush_kv_after_a_queued_read_of_the_stream():
    """A queued read of a stream commits its staged tail when flush_kv
    drains the queue; flush_kv then has nothing left to commit (the
    reference raises there, stacking an empty window)."""
    dev = ttier.make_device("trace", kv_window=16, device="cpu")
    kv = synth.kv_cache(20, 64, seed=33)
    dev.write_kv("s", kv)
    t, = dev.submit_async([ttier.ReadReq("s", kind=ttier.KV)])
    dev.flush_kv("s")
    assert t.done and dev.n_blocks("s") == 2
    np.testing.assert_array_equal(t.wait().data, kv)
    np.testing.assert_array_equal(dev.read_kv("s"), kv)


def test_receipt_byte_sums():
    dev = ttier.make_device("trace", kv_window=16, device="cpu")
    wrec, = dev.submit([ttier.WriteReq("w", synth.weights(3_000, seed=1))])
    rrec, = dev.submit([ttier.ReadReq("w", view=tprec.MAN4)])
    for rec in (wrec, rrec):
        assert rec.dram_bytes == rec.dram_bytes_read + rec.dram_bytes_written
        assert rec.link_bytes == rec.link_bytes_in + rec.link_bytes_out
    assert wrec.link_bytes == 6_000 and rrec.dram_bytes == \
        rrec.dram_bytes_read > 0


# ---------------------------------------------------------------------------
# pool prefetch
# ---------------------------------------------------------------------------

def _filled_pool(mod, kind="trace", pages=6, layers=1, policy=None,
                 shards=1):
    """The reference test's pool (``test_tier_async.py``) in either
    package."""
    if mod is tpaging:
        dev = ttier.make_device(kind, shards=shards, device="cpu")
    else:
        dev = rtier.make_device(kind, shards=shards)
    kw = {"policy": policy} if policy is not None else {}
    pool = mod.KVPagePool(dev, page_tokens=8,
                          hbm_budget_bytes=8 * 64 * 2 * 2, **kw)
    rng = np.random.default_rng(0)
    for i in range(pages):
        for layer in range(layers):
            page = (rng.normal(size=(8, 64)).astype(np.float32)
                    .view(np.uint32) >> 16).astype(np.uint16)
            pool.append_page(layer, "k", i * 8, page,
                             importance=float(i * layers + layer))
    return pool


def _tier(pool):
    return pool.tier if isinstance(pool, tpaging.KVPagePool) else pool.device


def _stats_dict(stats):
    return {f: getattr(stats, f) for f in SUM_FIELDS}


def _traffic(pool):
    return {k: vars(t) for k, t in pool.page_traffic.items()}


@pytest.mark.parametrize("shards", [1, 3])
def test_pool_prefetch_served_by_read_layer(shards):
    outs = []
    for mod in (tpaging, rpaging):
        plain, pre = (_filled_pool(mod, shards=shards),
                      _filled_pool(mod, shards=shards))
        want = plain.read_layer(0, "k")
        n = pre.prefetch_layer(0, "k")
        assert n == pre.spilled_pages > 0
        assert pre.prefetch_layer(0, "k") == 0      # already in flight
        assert _tier(pre).pending == n or shards > 1
        got = pre.read_layer(0, "k")
        np.testing.assert_array_equal(want, got)
        assert not pre._prefetched
        assert _stats_dict(_tier(plain).stats) == _stats_dict(
            _tier(pre).stats)
        outs.append((got, _traffic(pre), _stats_dict(_tier(pre).stats)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


def test_pool_prefetch_views_match_read_layer_multilayer_lossy():
    outs = []
    for mod in (tpaging, rpaging):
        plain = _filled_pool(mod, layers=2, policy=mod.PAPER_POLICY)
        pre = _filled_pool(mod, layers=2, policy=mod.PAPER_POLICY)
        want0, want1 = plain.read_layer(0, "k"), plain.read_layer(1, "k")
        assert pre.prefetch_layer(0, "k") > 0
        assert pre.prefetch_layer(1, "k") > 0
        got0, got1 = pre.read_layer(0, "k"), pre.read_layer(1, "k")
        np.testing.assert_array_equal(want0, got0)
        np.testing.assert_array_equal(want1, got1)
        assert not pre._prefetched
        assert _stats_dict(_tier(plain).stats) == _stats_dict(
            _tier(pre).stats)
        outs.append((got0, got1, _traffic(pre)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def _pool_traffic_sums(pool):
    fields = ("dram_bytes_read", "dram_bytes_written",
              "link_bytes_in", "link_bytes_out", "index_bytes")
    return {f: sum(getattr(t, f) for t in pool.page_traffic.values())
            for f in fields}


def test_abandoned_prefetch_stays_conserved():
    """A prefetch flushed by unrelated traffic but never consumed still
    folds into the pool's receipts exactly once."""
    outs = []
    for mod in (tpaging, rpaging):
        pool = _filled_pool(mod)
        assert pool.prefetch_layer(0, "k") > 0
        spilled = [p for p in pool.iter_pages() if p.resident is None]
        pool.read_pages(spilled[:1])    # drains the queue: prefetch runs
        assert all(e[0].done for e in pool._prefetched.values())
        d = pool.stats()
        want = {f: getattr(d, f) for f in
                ("dram_bytes_read", "dram_bytes_written",
                 "link_bytes_in", "link_bytes_out", "index_bytes")}
        assert _pool_traffic_sums(pool) == want
        before = pool.stats().dram_bytes_read
        data = pool.read_layer(0, "k")
        after = pool.stats().dram_bytes_read
        assert not pool._prefetched
        assert _pool_traffic_sums(pool)["dram_bytes_read"] == after
        assert after == before          # served from the settled prefetch
        outs.append((data, _traffic(pool)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


def _kv_pages(n, seed0=40):
    return [(0, "k", 16 * i, synth.kv_cache(16, 64, seed=seed0 + i),
             float(i), f"h{i}") for i in range(n)]


def test_read_after_reclaim_reflects_truncation_despite_prefetch():
    """prefetch_layer -> reclaim -> read_layer serves the degraded state
    (what a fresh read returns), not the stale prefetched bytes."""
    outs = []
    for mod, prec in ((tpaging, tprec), (rpaging, rprec)):
        kw = dict(page_tokens=16, hbm_budget_bytes=0,
                  policy=mod.LOSSLESS_POLICY, key_prefix="r0.",
                  degrade_ladder=(prec.MAN0,), sanitize=True)
        if mod is tpaging:
            kw["device"] = "cpu"
        pool = mod.KVPagePool("trace", **kw)
        pool.append_pages([e[:5] for e in _kv_pages(3)])
        full = pool.read_layer(0, "k")
        assert pool.prefetch_layer(0, "k") == 3
        freed = pool.reclaim(1)             # truncates the coldest page
        assert freed > 0
        got = pool.read_layer(0, "k")
        tier, req = ((pool.tier, ttier.ReadReq) if mod is tpaging
                     else (pool.device, rtier.ReadReq))
        want = np.concatenate([
            tier.submit([req(p.key, kind="kv")])[0].data
            for p in sorted(pool.iter_pages(), key=lambda p: p.start)
        ], axis=0)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, full)
        assert not pool._prefetched
        outs.append((got, freed, _traffic(pool)))
        pool.release()
        assert tier.resident_bytes() == 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


def test_pool_release_settles_outstanding_prefetch():
    outs = []
    for mod in (tpaging, rpaging):
        pool = _filled_pool(mod)
        n = pool.prefetch_layer(0, "k")
        assert n > 0 and _tier(pool).pending == n
        pool.release()
        assert not pool._prefetched and _tier(pool).pending == 0
        assert _pool_traffic_sums(pool)["dram_bytes_read"] == \
            _tier(pool).stats.dram_bytes_read > 0
        outs.append(_traffic(pool))
    assert outs[0] == outs[1]


def test_pool_accounting_helpers_identical_to_reference():
    outs = []
    for mod, prec in ((tpaging, tprec), (rpaging, rprec)):
        dev = (ttier.make_device("trace", kv_window=16, device="cpu")
               if mod is tpaging else rtier.make_device("trace",
                                                        kv_window=16))
        idx = mod.PrefixShareIndex(dev)
        pools = [mod.KVPagePool(dev, page_tokens=16,
                                hbm_budget_bytes=2 * 16 * 64 * 2,
                                policy=mod.PAPER_POLICY, key_prefix=f"r{i}.",
                                prefix_index=idx) for i in range(2)]
        for i, pool in enumerate(pools):
            pool.append_pages(_kv_pages(3))          # shared prompt pages
            for j in range(4):
                pool.append_page(1 + j % 2, "v", 16 * j,
                                 synth.kv_cache(16, 64, seed=70 + 5 * i + j),
                                 importance=float(j))
        spilled = [p for p in pools[0].iter_pages() if p.resident is None]
        page = pools[0].read_page(spilled[0])
        layer = pools[0].read_layer(1, "v")
        rec = dict(
            page=page.tobytes(), layer=layer.tobytes(),
            dev_res=[p.device_resident_bytes for p in pools],
            shared=[p.shared_resident_bytes for p in pools],
            phys=[p.physical_kv_bytes for p in pools],
            by_layer=[{k: vars(v) for k, v in p.traffic_by_layer().items()}
                      for p in pools],
            avg=[mod.PAPER_POLICY.avg_bits(n) for n in (0, 1, 5, 8, 10, 40)],
            lossless=mod.LOSSLESS_POLICY.avg_bits(7))
        outs.append(rec)
    assert outs[0] == outs[1]
    assert outs[0]["avg"][0] == 16.0 and outs[0]["avg"][-1] < 16.0
    assert all(s > 0 for s in outs[0]["shared"])
    merged = tpaging.PageTraffic(dram_bytes_read=3, requests=1)
    merged.merge(tpaging.PageTraffic(dram_bytes_read=4, link_bytes_out=2,
                                     requests=2))
    assert (merged.dram_bytes_read, merged.link_bytes_out,
            merged.requests) == (7, 2, 3)


# ---------------------------------------------------------------------------
# the engine's readback helpers
# ---------------------------------------------------------------------------

ENGINE = dict(max_seq=96, batch=1, page_tokens=16, hbm_kv_budget=1 << 12)


@pytest.fixture(scope="module")
def models(smoke_model):
    import jax

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import model as tm

    rcfg, rparams = smoke_model("qwen2-0.5b")
    tcfg = smoke_config(ARCHS["qwen2-0.5b"])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return rcfg, rparams, tcfg, tparams


class _PoolLog:
    """Every page-pool call an engine makes, by page key, to replay on
    the reference's pool."""

    def __init__(self, pool):
        self.calls = []
        for name in ("append_pages", "read_pages", "read_pages_async",
                     "drain_reads"):
            self._wrap(pool, name)

    def _wrap(self, pool, name):
        fn = getattr(pool, name)

        def logged(arg):
            if name == "append_pages":
                self.calls.append((name, [tuple(e) for e in arg]))
            elif name == "drain_reads":
                self.calls.append((name, [t.request.key for t in arg]))
            else:
                self.calls.append((name, [p.key for p in arg]))
            return fn(arg)
        setattr(pool, name, logged)

    def replay(self, pool):
        tickets = {}
        for name, arg in self.calls:
            if name == "append_pages":
                pool.append_pages(arg)
                pool.spill_events = []
                continue
            if name == "drain_reads":
                pool.drain_reads([tickets.pop(k) for k in arg])
                continue
            by_key = {p.key: p for p in pool.iter_pages()}
            pages = [by_key[k] for k in arg]
            if name == "read_pages":
                pool.read_pages(pages)
            else:
                tickets.update(zip(arg, pool.read_pages_async(pages)))


@pytest.mark.parametrize("async_io", [False, True])
def test_kv_through_tier_and_layer_traffic(models, async_io):
    from repro.runtime import ServeEngine as RServe
    from repro_torch.runtime import ServeEngine as TServe

    rcfg, rparams, tcfg, tparams = models
    teng = TServe(tcfg, tparams, policy=tpaging.PAPER_POLICY, device="cpu",
                  async_io=async_io, **ENGINE)
    log = _PoolLog(teng.pool)
    toks = (np.arange(60, dtype=np.int32).reshape(1, 60) * 7) % tcfg.vocab
    teng.prefill(toks[:, :48])
    for t in range(48, 60):
        teng.decode(toks[:, t : t + 1])
    teng.flush_io()
    # the reference's pool fed the engine's page stream gives the same
    # words and per-layer traffic
    rpool = rpaging.KVPagePool("trace", 16, 1 << 12, rpaging.PAPER_POLICY)
    log.replay(rpool)
    assert teng.pool.spilled_pages > 0
    served = teng.layer_traffic()
    assert {k: vars(v) for k, v in served.items()} == \
        {k: vars(v) for k, v in rpool.traffic_by_layer().items()}
    for layer in range(tcfg.n_layers):
        for kind in "kv":
            np.testing.assert_array_equal(teng.kv_through_tier(layer, kind),
                                          rpool.read_layer(layer, kind))
    traffic = teng.layer_traffic()
    assert {k: vars(v) for k, v in traffic.items()} == \
        {k: vars(v) for k, v in rpool.traffic_by_layer().items()}
    assert sorted(traffic) == list(range(tcfg.n_layers))
    got = teng.kv_through_tier(0, "k")
    assert got.shape == (48, tcfg.n_kv_heads * tcfg.head_dim)
    # against the reference engine on the same tokens: the traffic that
    # does not depend on the KV values is identical
    reng = RServe(rcfg, rparams, policy=rpaging.PAPER_POLICY,
                  async_io=async_io, **ENGINE)
    reng.prefill(toks[:, :48])
    for t in range(48, 60):
        reng.decode(toks[:, t : t + 1])
    theirs = reng.layer_traffic()
    assert sorted(served) == sorted(theirs)
    for layer, t in served.items():
        r = theirs[layer]
        assert (t.requests, t.link_bytes_in, t.link_bytes_out,
                t.index_bytes) == (r.requests, r.link_bytes_in,
                                   r.link_bytes_out, r.index_bytes)
    assert reng.kv_through_tier(0, "k").shape == got.shape


# ---------------------------------------------------------------------------
# the example twins, at smoke width on the CPU
# ---------------------------------------------------------------------------

def test_quickstart_example_cpu(capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main(["--cpu"])
    text = capsys.readouterr().out
    assert "lossless round-trip: OK" in text
    assert out["ratios"]["trace"] > out["ratios"]["plain"] == 1.0
    assert out["low_bytes"] < out["full_bytes"] and 0 < out["rel"] < 0.05


def test_serve_async_example_cpu(capsys):
    from repro_torch.examples import serve_async

    out = serve_async.main(["--cpu"])
    text = capsys.readouterr().out
    assert "tokens identical" in text
    raw = out["raw"]
    assert raw["done"] + raw["pending"] == 8 and raw["pending"] > 0
    assert raw["serial"] > raw["total"]
    s, a = out["overlap"]["sync"], out["overlap"]["async_"]
    assert (s.tier_dram_read, s.tier_dram_stored) == (a.tier_dram_read,
                                                      a.tier_dram_stored)
    assert sum(out["streams"]["per_read"]) == out["streams"]["device_read"]


def test_serve_continuous_example_cpu(capsys):
    from repro_torch.examples import serve_continuous

    out = serve_continuous.main(["--cpu"])
    text = capsys.readouterr().out
    assert "bit-identical to solo runs" in text
    assert out["stored"] == 0 and out["blocks"] == 0
    assert out["physical"].peak_active >= out["report"].peak_active
    assert all(r.finished for r in out["report"].records)


def test_serve_elastic_example_cpu(capsys):
    """stablelm-12b (layernorm) at smoke width through four KV policies:
    lossless agrees with itself on every top-1, and tier DRAM reads fall
    from lossless to aggressive."""
    from repro_torch.examples import serve_elastic

    out = serve_elastic.main(["--cpu"])
    text = capsys.readouterr().out
    assert "per-layer tier DRAM traffic" in text
    rows = out["rows"]
    lossless = rows["lossless (all BF16)"]
    aggressive = rows["aggressive (all man0+guard)"]
    assert lossless["top1"] == 1.0 and lossless["mse"] == 0.0
    assert aggressive["dram_read"] < rows["mid (all man2+guard)"][
        "dram_read"] < lossless["dram_read"]
    assert aggressive["mse"] > 0.0
    assert sum(out["per_layer"].values()) == aggressive["dram_read"]
