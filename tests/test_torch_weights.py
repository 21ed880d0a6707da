"""Port vs reference: the weight store (``runtime.weights``) and the
``replicate-weights`` fleet.

* the reference's four ``WeightStore`` tests, on the port;
* ``put_many`` / ``fetch_all`` through both packages' ``trace``,
  ``gcomp`` and ``plain`` stores: every receipt field and every word
  identical (tolerance 0), views and ``avg_bits`` equal, ties in
  importance ranked in insertion order by both;
* one request script through both packages' ``replicate-weights``
  fleets (weights replicated, KV hash-striped, sync and async reads, a
  truncation, deletes): receipts, read routing, every shard's blocks,
  ledger, stats and busy clock identical, and the reads spread;
* the reference's slow-shard cases (``link_models=``) and
  ``shard_factory``, on the port and against the reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import precision as rprec  # noqa: E402
from repro.core import sharding as rshard  # noqa: E402
from repro.core import synth as rsynth  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro.runtime import weights as rweights  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import sharding as tshard  # noqa: E402
from repro_torch.core import synth  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402
from repro_torch.core.precision import FULL  # noqa: E402
from repro_torch.runtime import DEFAULT_TIERS, WeightStore  # noqa: E402
from test_torch_pnm import RECEIPT_FIELDS, same_receipts  # noqa: E402

SUM_FIELDS = [f.name for f in dataclasses.fields(ttier.DeviceStats)]


def _bf16(u16: np.ndarray, shape) -> torch.Tensor:
    return torch.from_numpy(u16.view(np.int16).copy()).view(
        torch.bfloat16).reshape(shape)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


def _units(n=10, sz=(64, 128), seed=0, imps=None):
    """``name -> (bf16 tensor, importance)``, as the reference test
    builds them from ``synth.weights``."""
    out = {}
    for i in range(n):
        w = synth.weights(sz[0] * sz[1], "bf16", seed=seed + i)
        imp = float(n - i) if imps is None else imps[i]
        out[f"expert{i}"] = (_bf16(w, sz), imp)
    return out


def _ref_units(units):
    import ml_dtypes

    return {k: (_words(w).view(ml_dtypes.bfloat16).reshape(tuple(w.shape)),
                imp) for k, (w, imp) in units.items()}


# ---------------------------------------------------------------------------
# the reference's WeightStore tests, on the port
# ---------------------------------------------------------------------------

def test_full_view_byte_exact_roundtrip():
    ws = WeightStore("trace", tiers=((1.0, FULL),), device="cpu")
    units = _units(4)
    for name, (w, imp) in units.items():
        ws.put(name, w, imp)
    for name, (w, _) in units.items():
        got = ws.fetch(name)
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        np.testing.assert_array_equal(_words(got), _words(w))


def test_importance_ranked_views_scale_traffic():
    """Cold units must cost fewer DRAM bytes than hot ones (plane fetch)."""
    ws = WeightStore("trace", device="cpu")
    for name, (w, imp) in _units(10).items():
        ws.put(name, w, imp)
    assert ws.view_for("expert0").name == "bf16"
    assert ws.view_for("expert9").name == "man0"
    ws.stats.reset_traffic()
    ws.fetch("expert0")
    hot = ws.stats.dram_bytes_read
    ws.stats.reset_traffic()
    ws.fetch("expert9")
    cold = ws.stats.dram_bytes_read
    assert cold < hot * 0.85
    assert 9 <= ws.avg_bits() < 16


def test_word_device_cannot_scale_traffic():
    """CXL-Plain always moves full containers (paper Issue 2)."""
    tr = WeightStore("trace", device="cpu")
    pl = WeightStore("plain", device="cpu")
    for store in (tr, pl):
        for name, (w, imp) in _units(10, seed=3).items():
            store.put(name, w, imp)
        store.stats.reset_traffic()
        store.fetch_all()
    assert tr.stats.dram_bytes_read < 0.8 * pl.stats.dram_bytes_read


def test_importance_update_changes_views():
    ws = WeightStore("trace", device="cpu")
    for name, (w, imp) in _units(10).items():
        ws.put(name, w, imp)
    assert ws.view_for("expert9").name == "man0"
    ws.set_importance({"expert9": 100.0, "absent": 1.0})
    assert ws.view_for("expert9").name == "bf16"


# ---------------------------------------------------------------------------
# both packages' stores on the same units
# ---------------------------------------------------------------------------

def _record(tier):
    """Collect every receipt ``tier.submit`` returns."""
    recs, submit = [], tier.submit

    def wrapped(reqs):
        out = submit(reqs)
        recs.extend(out)
        return out
    tier.submit = wrapped
    return recs


def _both(kind, units, tiers=DEFAULT_TIERS, **kw):
    t = WeightStore(kind, tiers=tiers, device="cpu", **kw)
    r = rweights.WeightStore(kind, tiers=tiers)
    trecs, rrecs = _record(t.tier), _record(r.device)
    t.put_many(units)
    r.put_many(_ref_units(units))
    return t, r, trecs, rrecs


def _same_stores(t, r, trecs, rrecs):
    same_receipts(trecs, rrecs)
    for f in SUM_FIELDS:
        assert getattr(t.stats, f) == getattr(r.stats, f), f
    assert t.stats.bypass_rate == r.stats.bypass_rate
    assert t.avg_bits() == r.avg_bits()
    for name in r._units:
        assert t.view_for(name) == r.view_for(name)
        assert t.tier.n_blocks(name) == r.device.n_blocks(name)
        assert t.tier.footprint(name) == r.device.footprint(name)
        assert t.tier.logical_bytes(name) == r.device.logical_bytes(name)


@pytest.mark.parametrize("kind", ["trace", "gcomp", "plain"])
def test_put_many_fetch_all_identical_to_reference(kind):
    units = _units(7, sz=(32, 96), seed=20)
    units["odd"] = (_bf16(synth.weights(3 * 1001, "fp8", seed=5), (3, 1001)),
                    2.5)
    t, r, trecs, rrecs = _both(kind, units)
    assert [rec.op for rec in trecs] == ["write"] * len(units)
    tout, rout = t.fetch_all(), r.fetch_all()
    assert list(tout) == list(rout)
    for name, w in rout.items():
        assert tuple(tout[name].shape) == w.shape
        np.testing.assert_array_equal(_words(tout[name]), w.view(np.uint16))
    single_t = t.fetch("expert3", FULL)
    single_r = r.fetch("expert3", rprec.FULL)
    np.testing.assert_array_equal(_words(single_t),
                                  single_r.view(np.uint16))
    _same_stores(t, r, trecs, rrecs)
    if kind == "trace":
        assert t.stats.dram_bytes_stored < t.stats.raw_bytes_stored


def test_tied_importance_keeps_insertion_order():
    imps = [3.0, 1.0, 3.0, 3.0, 1.0, 2.0, 3.0, 1.0, 2.0, 3.0]
    units = _units(10, sz=(16, 64), seed=40, imps=imps)
    t, r, trecs, rrecs = _both("trace", units)
    views = [t.view_for(n) for n in units]
    assert views == [r.view_for(n) for n in units]
    # the five 3.0 units take ranks 0..4 in insertion order: the first
    # four fit the FULL tier (0.4 of 10 units), the last takes MAN4
    tied = [views[i].name for i in (0, 2, 3, 6, 9)]
    assert tied == ["bf16", "bf16", "bf16", "bf16", "man4"]
    t.set_importance({"expert1": 9.0})
    r.set_importance({"expert1": 9.0})
    assert [t.view_for(n) for n in units] == [r.view_for(n) for n in units]
    tout, rout = t.fetch_all(), r.fetch_all()
    for name, w in rout.items():
        np.testing.assert_array_equal(_words(tout[name]), w.view(np.uint16))
    _same_stores(t, r, trecs, rrecs)


def test_rejected_batch_registers_no_unit():
    ws = WeightStore("trace", device="cpu")
    bad = {"a": (_bf16(synth.weights(64, seed=1), (64,)), 1.0),
           "b": (_bf16(synth.weights(60, seed=2), (60,)), 1.0)}
    ws.tier.block_elems = 12          # not a multiple of 8: encode refuses
    with pytest.raises(ValueError):
        ws.put_many(bad)
    assert ws.avg_bits() == 16.0
    with pytest.raises(StopIteration):
        ws.view_for("a")


def test_numpy_units_cast_like_ml_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(4)
    w = (rng.standard_normal((32, 40)) * 0.03).astype(np.float32)
    ws = WeightStore("trace", tiers=((1.0, FULL),), device="cpu")
    ws.put("w", w)
    np.testing.assert_array_equal(
        _words(ws.fetch("w")), w.astype(ml_dtypes.bfloat16).view(np.uint16))
    ws.put("w64", w.astype(np.float64) * 3.3)
    np.testing.assert_array_equal(
        _words(ws.fetch("w64")),
        (w.astype(np.float64) * 3.3).astype(ml_dtypes.bfloat16)
        .view(np.uint16))


# ---------------------------------------------------------------------------
# replicate-weights fleets, port vs reference
# ---------------------------------------------------------------------------

def _fleet(mod, n=4, **kw):
    if mod is tshard:
        return tshard.ShardedTierStore(n, kind="trace",
                                       placement="replicate-weights",
                                       sanitize=True, window=2,
                                       kv_window=16, device="cpu", **kw)
    return rshard.ShardedTierStore(n, kind="trace",
                                   placement="replicate-weights",
                                   sanitize=True, window=2, kv_window=16,
                                   **kw)


def _replicate_script(port: bool):
    """Weights replicated (one put_many), KV pages hash-striped, then
    sync fetches, async per-unit reads that spill the window, a
    truncation of a replicated unit, a KV read and deletes."""
    tmod, pmod, store_cls = ((ttier, tprec, WeightStore) if port
                             else (rtier, rprec, rweights.WeightStore))
    fleet = _fleet(tshard if port else rshard)
    ws = store_cls(fleet)
    units = _units(6, sz=(32, 128), seed=60)
    recs = []
    ws.put_many(units if port else _ref_units(units))
    kv = rsynth.kv_cache(16 * 4, 64, seed=7)
    recs += fleet.submit([tmod.WriteReq(f"r0.L0.k.{i}",
                                        kv[16 * i:16 * (i + 1)],
                                        kind=tmod.KV) for i in range(4)])
    words = [ws.fetch_all()]
    views = {n: ws.view_for(n) for n in units}
    for n in units:
        recs += fleet.submit([tmod.ReadReq(n, view=views[n], tag=n)])
    tickets = []
    for n in units:
        tickets += fleet.submit_async([tmod.ReadReq(n, view=views[n])])
    pending = fleet.pending
    recs += fleet.drain(tickets)
    fleet.quiesce()
    reclaimed = fleet.truncate_planes(["expert5"], pmod.MAN4)
    recs += fleet.submit([tmod.ReadReq("expert5", view=pmod.FULL),
                          tmod.ReadReq("r0.L0.k.2", kind=tmod.KV)])
    words.append(ws.fetch_all())
    state = dict(pending=pending, reclaimed=reclaimed,
                 resident=fleet.resident_bytes(),
                 backlog=fleet.busy_backlog_s, skew=fleet.fleet_skew(),
                 window=fleet.window, ratio=fleet.compression_ratio(),
                 bypass=fleet.stats.bypass_rate,
                 blocks=[fleet.n_blocks(n) for n in units],
                 footprint=[fleet.footprint(n) for n in units],
                 logical=[fleet.logical_bytes(n) for n in units])
    state["copies"] = [s.resident_bytes("expert1") for s in fleet.shards]
    fleet.delete("expert0")
    state["after_delete"] = [s.resident_bytes() for s in fleet.shards]
    state["released"] = fleet.delete_prefix("r0")
    state["after_prefix"] = [s.resident_bytes() for s in fleet.shards]
    return fleet, recs, words, state


def _view(v):
    return None if v is None else (v.r_e, v.r_m, v.d_e, v.d_m, v.name)


def test_replicate_weights_fleet_identical_to_reference():
    tf, trecs, twords, tstate = _replicate_script(port=True)
    rf, rrecs, rwords, rstate = _replicate_script(port=False)
    same_receipts(trecs, rrecs)
    assert tstate == rstate
    assert tstate["pending"] > 0 and tstate["reclaimed"] > 0
    for tw, rw in zip(twords, rwords):
        for name, w in rw.items():
            np.testing.assert_array_equal(_words(tw[name]), w.view(np.uint16))
    for ts, rs in zip(tf.shards, rf.shards, strict=True):
        assert ts._tensors.keys() == rs._tensors.keys()
        for key, blocks in rs._tensors.items():
            assert [(b.payloads, b.flags, _view(b.view))
                    for b in ts._tensors[key]] == \
                [(b.payloads, b.flags, _view(b.view)) for b in blocks]
        assert {k: dataclasses.asdict(e) for k, e in ts._ledger.items()} == \
            {k: dataclasses.asdict(e) for k, e in rs._ledger.items()}
        for f in SUM_FIELDS:
            assert getattr(ts.stats, f) == getattr(rs.stats, f), f
        assert (ts._now_s, ts._ddr_free_s, ts._link_free_s) == \
            (rs._now_s, rs._ddr_free_s, rs._link_free_s)
    # tensor reads spread over the replicas; every shard holds every unit
    reads = [r.device_id for r in trecs
             if r.op == "read" and r.kind == "tensor"]
    assert len(set(reads)) > 1
    assert len(set(tstate["copies"])) == 1 and tstate["copies"][0] > 0


def test_replicated_write_returns_home_receipt_and_lands_everywhere():
    fleet = _fleet(tshard)
    solo = ttier.make_device("trace", kv_window=16, device="cpu")
    w = synth.weights(5_000, seed=9)
    rec, = fleet.submit([ttier.WriteReq("w", w)])
    want, = solo.submit([ttier.WriteReq("w", w)])
    assert rec.device_id == fleet.owner("w")
    for f in RECEIPT_FIELDS:
        if f != "device_id":
            assert getattr(rec, f) == getattr(want, f), f
    for s in fleet.shards:
        assert s.resident_bytes("w") == solo.resident_bytes("w")
    # the fleet's receipts sum to one shard's stats; the fleet view holds
    # every copy
    assert fleet.stats.dram_bytes_stored == 4 * rec.dram_bytes_stored
    np.testing.assert_array_equal(fleet.read_tensor("w"), w)


# ---------------------------------------------------------------------------
# the reference's slow-shard cases (link_models=) and shard_factory
# ---------------------------------------------------------------------------

def _session(dev, mod):
    pages = {f"r{i}.p{j}": rsynth.kv_cache(16, 32, seed=90 + 4 * i + j)
             for i in range(4) for j in range(3)}
    wrecs = dev.submit([mod.WriteReq(k, v, kind=mod.KV)
                        for k, v in pages.items()])
    rrecs = dev.drain(dev.submit_async(
        [mod.ReadReq(k, kind=mod.KV) for k in pages]))
    return wrecs + rrecs


def _models(mod):
    fast = mod.LinkModel()
    slow = mod.LinkModel(ddr_bw=fast.ddr_bw / 64, link_bw=fast.link_bw / 64,
                         base_s=fast.base_s * 64)
    return fast, slow


def test_slow_shard_changes_latency_never_bytes():
    fast, slow = _models(ttier)
    balanced = tshard.ShardedTierStore(4, kind="trace", kv_window=16,
                                       link_models=[fast] * 4, device="cpu")
    degraded = tshard.ShardedTierStore(4, kind="trace", kv_window=16,
                                       link_models=[slow] + [fast] * 3,
                                       device="cpu")
    ra, rb = _session(balanced, ttier), _session(degraded, ttier)
    slow_hit = False
    sum_fields = [f for f in SUM_FIELDS if f != "device_compute_s"]
    for a, b in zip(ra, rb):
        for f in sum_fields + ["key", "op", "kind", "device_id"]:
            assert getattr(a, f) == getattr(b, f), f
        if a.data is None:
            assert b.data is None
        else:
            np.testing.assert_array_equal(a.data, b.data)
        assert b.latency_s >= a.latency_s
        if b.device_id == 0 and b.latency_s > a.latency_s:
            slow_hit = True
    assert slow_hit, "no request ever touched the slow shard"
    for f in sum_fields:
        assert sum(getattr(r, f) for r in rb) == getattr(degraded.stats, f), f
    assert degraded.fleet_skew() == balanced.fleet_skew()
    # and the reference's degraded fleet prices every receipt the same
    rfast, rslow = _models(rtier)
    ref = rshard.ShardedTierStore(4, kind="trace", kv_window=16,
                                  link_models=[rslow] + [rfast] * 3)
    same_receipts(rb, _session(ref, rtier))


def test_slow_shard_gates_async_completion():
    """The straggler's queue, not the fleet average, bounds drain time."""
    fast, slow = _models(ttier)
    done = {}
    for tag, models in (("balanced", [fast] * 4),
                        ("slow", [slow] + [fast] * 3)):
        dev = tshard.ShardedTierStore(4, kind="trace", kv_window=16,
                                      link_models=models, device="cpu")
        dev.submit([
            ttier.WriteReq(f"p{i}", rsynth.kv_cache(16, 64, seed=110 + i),
                           kind=ttier.KV)
            for i in range(16)
        ])
        dev.quiesce()
        recs = dev.drain(dev.submit_async(
            [ttier.ReadReq(f"p{i}", kind=ttier.KV) for i in range(16)]))
        done[tag] = max(r.latency_s for r in recs)
    assert done["slow"] > done["balanced"]
    assert dev.busy_backlog_s == 0.0      # drain leaves no residual work


def test_shard_factory_and_link_model_checks():
    fast, slow = _models(ttier)

    def factory(i):
        return ttier.make_device("trace", kv_window=16, device="cpu",
                                 device_id=i,
                                 link_model=slow if i == 2 else fast)

    fleet = tshard.ShardedTierStore(3, shard_factory=factory)
    assert [s.link_model for s in fleet.shards] == [fast, fast, slow]
    assert fleet.link_model == fast and fleet.window == 64
    with pytest.raises(ValueError, match="device_id"):
        tshard.ShardedTierStore(2, shard_factory=lambda i: ttier.make_device(
            "trace", device="cpu"))
    with pytest.raises(ValueError, match="link_models"):
        tshard.ShardedTierStore(3, kind="trace", link_models=[fast],
                                device="cpu")
    bare = tshard.ShardedTierStore(2, layout="word-comp", device="cpu")
    assert bare.layout.name == "word-comp" and not bare.sanitize
