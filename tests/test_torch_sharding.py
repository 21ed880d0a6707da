"""Port vs reference: tier fleets (``core.sharding.ShardedTierStore``).

* the same request script (tensor and KV writes, reads, gathers,
  namespace and key deletes) through the port's fleet and the
  reference's, for both ported placements, sync and async: receipts
  identical field by field (gather scores within the f32 summation bound
  of ``tests/test_torch_pnm.py``), every shard's blocks, ledger, stats and
  busy clock identical, fleet views equal;
* one device and four shards give byte-identical gathers (bounded, zero
  and covering k) and break ties by candidate position;
* a malformed fleet batch rejects before any shard commits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sharding as rshard  # noqa: E402
from repro.core import synth  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import sharding as tshard  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402
from test_torch_pnm import CH, same_receipts  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROWS = 32
PLACEMENTS = ["hash-stripe", "namespace"]


def _script(mod, pmod):
    """Request batches over two request namespaces, a shared page and a
    tensor, with gathers spanning shards."""
    kv = synth.kv_cache(ROWS * 9, CH, seed=21)
    w = synth.weights(6_000, seed=3)
    W, R, G, KV, T = mod.WriteReq, mod.ReadReq, mod.GatherReq, mod.KV, \
        mod.TENSOR
    keys = tuple(f"r{i % 2}.L0.k.{i}" for i in range(6)) + ("shared.h0.L0.k",)
    d = np.sin(np.arange(CH)).astype(np.float32)
    return keys, [
        [W(k, kv[i * ROWS:(i + 1) * ROWS], kind=KV)
         for i, k in enumerate(keys)] + [W("w", w, kind=T)],
        [G(keys, d, 3, views=(pmod.FULL, pmod.MAN4) * 3 + (pmod.MAN0,)),
         R("w", kind=T, view=pmod.MAN4), R("r0.L0.k.0", kind=KV)],
        [W("r1.L0.k.1", kv[7 * ROWS:8 * ROWS], kind=KV),
         G(keys[::-1], -d, 2), G(keys[:2], d, 0), G(keys, d, 99)],
        [R("w", kind=T), G((keys[2],), d, 1)],
    ]


def _fleet(mod, placement, n=4):
    if mod is ttier:
        return tshard.ShardedTierStore(n, kind="trace", placement=placement,
                                       sanitize=True, window=3, device="cpu")
    return rshard.ShardedTierStore(n, kind="trace", placement=placement,
                                   sanitize=True, window=3)


def _drive(mod, pmod, placement, mode):
    fleet = _fleet(mod, placement)
    keys, batches = _script(mod, pmod)
    if mode == "sync":
        recs = [r for b in batches for r in fleet.submit(b)]
    else:
        tickets = [t for b in batches for t in fleet.submit_async(b)]
        recs = fleet.drain(tickets)
    fleet.quiesce()
    before = fleet.resident_bytes()
    n = fleet.delete_prefix("r0")
    out = dict(before=before, n=n, resident=fleet.resident_bytes(),
               r1=fleet.resident_bytes("r1"), skew=fleet.fleet_skew(),
               owners=[fleet.owner(k) for k in keys + ("w",)])
    fleet.delete("w")
    out["after"] = fleet.resident_bytes()
    return fleet, recs, out


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_fleet_identical_to_reference(placement, mode):
    tf, trecs, tout = _drive(ttier, tprec, placement, mode)
    rf, rrecs, rout = _drive(rtier, rprec, placement, mode)
    same_receipts(trecs, rrecs)
    assert tout == rout and tout["n"] == 3
    assert tout["before"] > tout["resident"] > tout["after"] > 0
    assert [r.device_id for r in trecs] == [r.device_id for r in rrecs]
    assert len({r.device_id for r in trecs}) > 1 or placement == "namespace"
    for ts, rs in zip(tf.shards, rf.shards, strict=True):
        assert ts._tensors.keys() == rs._tensors.keys()
        for key, blocks in rs._tensors.items():
            assert [(b.payloads, b.flags) for b in ts._tensors[key]] == \
                [(b.payloads, b.flags) for b in blocks]
        assert {k: dataclasses.asdict(e) for k, e in ts._ledger.items()} == \
            {k: dataclasses.asdict(e) for k, e in rs._ledger.items()}
        for f in dataclasses.fields(rs.stats):
            assert getattr(ts.stats, f.name) == getattr(rs.stats, f.name)
        assert (ts._now_s, ts._ddr_free_s, ts._link_free_s) == \
            (rs._now_s, rs._ddr_free_s, rs._link_free_s)
    for f in dataclasses.fields(rtier.DeviceStats):
        assert getattr(tf.stats, f.name) == getattr(rf.stats, f.name)


def _pages(dev, n=6, seed=0, dup=False):
    kv = synth.kv_cache(ROWS * n, CH, seed=seed)
    keys = [f"p{i}" for i in range(n)]
    dev.submit([ttier.WriteReq(k, kv[:ROWS] if dup
                               else kv[i * ROWS:(i + 1) * ROWS], kind=ttier.KV)
                for i, k in enumerate(keys)])
    return keys


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("k", [0, 2, 9])
def test_gather_sharded_matches_solo(k, mode):
    digest = np.linspace(-1, 1, CH).astype(np.float32)
    recs = []
    for shards in (1, 4):
        dev = ttier.make_device("trace", shards=shards, sanitize=True,
                                device="cpu")
        keys = _pages(dev)
        req = ttier.GatherReq(tuple(keys), digest, k=k)
        recs.append(dev.submit([req])[0] if mode == "sync"
                    else dev.drain(dev.submit_async([req]))[0])
    r1, r4 = recs
    assert r1.gather.keys == r4.gather.keys
    assert r1.gather.indices == r4.gather.indices
    assert r1.gather.scores.tobytes() == r4.gather.scores.tobytes()
    for a, b in zip(r1.gather.data, r4.gather.data, strict=True):
        np.testing.assert_array_equal(a, b)
    assert len(r1.gather.keys) == min(k, len(keys))


@pytest.mark.parametrize("shards", [1, 4])
def test_gather_tie_break_by_candidate_position(shards):
    dev = ttier.make_device("trace", shards=shards, sanitize=True,
                            device="cpu")
    keys = _pages(dev, n=5, seed=7, dup=True)
    rec, = dev.submit([ttier.GatherReq(tuple(keys), np.ones(CH, np.float32),
                                       k=2)])
    assert rec.gather.keys == keys[:2] and rec.gather.indices == [0, 1]
    assert len(set(rec.gather.scores.tolist())) == 1


def test_make_device_builds_fleets(monkeypatch):
    fleet = ttier.make_device("trace", shards=3, placement="namespace",
                              device="cpu")
    assert isinstance(fleet, tshard.ShardedTierStore)
    assert fleet.n_shards == 3 and fleet.placement.name == "namespace"
    assert all(s.device == torch.device("cpu") for s in fleet.shards)
    monkeypatch.setenv("TRACE_SHARDS", "2")
    assert ttier.make_device("trace", device="cpu").n_shards == 2
    assert isinstance(ttier.make_device("trace", shards=1, device="cpu"),
                      ttier.TraceDevice)
    with pytest.raises(ValueError):
        tshard.ShardedTierStore(0, kind="trace", device="cpu")


def test_malformed_fleet_batch_rejects_before_any_commit():
    fleet = ttier.make_device("trace", shards=4, sanitize=True, device="cpu")
    keys = _pages(fleet)
    stored = fleet.stats.dram_bytes_stored
    kv = synth.kv_cache(ROWS, CH, seed=9)
    bad = [ttier.WriteReq("new0", kv, kind=ttier.KV),
           ttier.WriteReq("new1", kv, kind=ttier.KV),
           ttier.GatherReq(tuple(keys) + ("ghost",),
                           np.ones(CH, np.float32), k=1)]
    with pytest.raises(KeyError):
        fleet.submit(bad)
    with pytest.raises(KeyError):
        fleet.submit_async(bad)
    assert fleet.stats.dram_bytes_stored == stored
    assert fleet.resident_bytes("new") == 0
