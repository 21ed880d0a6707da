"""Port vs reference tier device: the same request sequence goes to both,
for all four layouts, sync and async.  Payload bytes and flags, every
``Receipt`` field (latency included), ledger rows and ``DeviceStats``
must be equal — the tier is the system's host↔device contract.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import synth  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.core import tier as rtier  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import tier as ttier  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LAYOUTS = ["word", "word-comp", "bitplane", "bitplane-kv"]
RECEIPT_FIELDS = [f.name for f in dataclasses.fields(ttier.Receipt)
                  if f.name != "data"]


def _views(mod):
    return {"full": mod.FULL, "man4": mod.MAN4, "man0": mod.MAN0,
            "score": mod.SCORE}


def _script(mod, view_mod):
    """A sequence of request batches touching every write/read rule:
    tensors, KV windows (whole, partial, implicit flush), views, block
    ranges, mixed batches and rewrites of read keys."""
    V = _views(view_mod)
    w = synth.weights(5_000, seed=0)
    kv = synth.kv_cache(160, 64, seed=1)
    kv2 = synth.kv_cache(40, 128, seed=2)
    W, R, KV, T = mod.WriteReq, mod.ReadReq, mod.KV, mod.TENSOR
    return [
        [W("w", w, kind=T), W("s0", kv[:64], kind=KV),
         W("s1", kv[64:100], kind=KV, flush=False)],
        [R("w", kind=T, view=V["man4"]), R("s0", kind=KV),
         R("w", kind=T, block_range=(1, 2))],
        [W("s1", kv[100:], kind=KV), R("s1", kind=KV, view=V["man0"]),
         W("s2", kv2, kind=KV)],
        [R("s2", kind=KV, view=V["score"]), R("s0", kind=KV, view=V["man4"]),
         R("s1", kind=KV), R("w", kind=T)],
        [W("w", w[:777], kind=T), R("w", kind=T, view=V["man0"]),
         R("s2", kind=KV)],
    ]


def _run(mod, view_mod, layout, mode, window=3):
    dev = mod.TierStore(layout, kv_window=32, window=window,
                        **({"device": "cpu"} if mod is ttier else {}))
    if mode == "sync":
        recs = [r for batch in _script(mod, view_mod)
                for r in dev.submit(batch)]
    else:
        # nothing waited until the end: window overflows and
        # write-after-read fences flush queued groups along the way
        tickets = [t for batch in _script(mod, view_mod)
                   for t in dev.submit_async(batch)]
        recs = [t.wait() for t in tickets[::-1]][::-1]
    dev.quiesce()
    return dev, recs


def _same_receipts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in RECEIPT_FIELDS:
            assert getattr(x, f) == getattr(y, f), (x.key, f)
        if y.data is None:
            assert x.data is None
        else:
            np.testing.assert_array_equal(x.data, y.data)


def _same_device(td, rd):
    assert td._tensors.keys() == rd._tensors.keys()
    for key, blocks in rd._tensors.items():
        for tb, rb in zip(td._tensors[key], blocks, strict=True):
            assert tb.payloads == rb.payloads and tb.flags == rb.flags
            assert (tb.valid_elems, tb.padded_elems) == \
                (rb.valid_elems, rb.padded_elems)
            assert (tb.view is None) == (rb.view is None)
    assert {k: dataclasses.asdict(e) for k, e in td._ledger.items()} == \
        {k: dataclasses.asdict(e) for k, e in rd._ledger.items()}
    for f in dataclasses.fields(rd.stats):
        assert getattr(td.stats, f.name) == getattr(rd.stats, f.name), f.name
    assert (td._now_s, td._ddr_free_s, td._link_free_s) == \
        (rd._now_s, rd._ddr_free_s, rd._link_free_s)


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_request_sequence_identical_to_reference(layout, mode):
    td, trecs = _run(ttier, tprec, layout, mode)
    rd, rrecs = _run(rtier, rprec, layout, mode)
    _same_receipts(trecs, rrecs)
    _same_device(td, rd)


@pytest.mark.parametrize("kind", ["plain", "gcomp", "trace"])
def test_named_devices_price_receipts_like_reference(kind):
    """make_device's per-design link models (controller anchors) give
    bit-equal latencies; async readback with a small window queues."""
    kv = synth.kv_cache(256, 128, seed=4)
    out = []
    for mod in (ttier, rtier):
        kw = {"device": "cpu"} if mod is ttier else {"shards": 1}
        dev = mod.make_device(kind, kv_window=64, window=2, **kw)
        recs = dev.submit([mod.WriteReq(f"p{i}", kv[64 * i: 64 * (i + 1)],
                                        kind=mod.KV) for i in range(4)])
        tickets = dev.submit_async([mod.ReadReq(f"p{i}", kind=mod.KV)
                                    for i in range(4)])
        recs += dev.drain(tickets)
        out.append((dev, recs))
    (td, trecs), (rd, rrecs) = out
    _same_receipts(trecs, rrecs)
    _same_device(td, rd)
    assert any(r.queue_delay_s > 0 for r in trecs)


def test_truncate_delete_refcount_and_sanitizer_identical():
    kv = synth.kv_cache(192, 64, seed=6)
    out = []
    for mod, pmod in ((ttier, tprec), (rtier, rprec)):
        kw = {"device": "cpu"} if mod is ttier else {}
        dev = mod.TierStore("bitplane-kv", kv_window=32, sanitize=True, **kw)
        W, R = mod.WriteReq, mod.ReadReq
        recs = dev.submit([W(f"r1.p{i}", kv[32 * i: 32 * (i + 1)],
                             kind=mod.KV) for i in range(6)]
                          + [W("r10.x", kv[:32], kind=mod.KV)])
        freed = dev.truncate_planes(["r1.p0", "r1.p1"], pmod.MAN4)
        freed += dev.truncate_planes(["r1.p0"], pmod.MAN0)
        recs += dev.submit([R("r1.p0", kind=mod.KV),
                            R("r1.p1", kind=mod.KV, view=pmod.MAN0)])
        assert dev.acquire("r1.p2") == 2
        n = dev.delete_prefix("r1")
        assert dev.release("r1.p2") == 0
        out.append((dev, recs, freed, n, dev.resident_bytes(),
                    dev.compression_ratio("r10")))
    (td, trecs, *tnum), (rd, rrecs, *rnum) = out
    _same_receipts(trecs, rrecs)
    _same_device(td, rd)
    assert tnum == rnum and tnum[0] > 0


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttier.make_device("trace")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttier.TierStore("bitplane-kv", device="cuda")


def _kv_view_script(mod, pmod):
    """KV streams read at FULL/MAN4/MAN0/SCORE, a TENSOR read beside them
    in the same decode slab, a MAN4-truncated block read at (r_m 2,
    d_m 4) — served at their intersection ``cut11`` — and a partial
    window flushed by its write (37 of 64 rows)."""
    kv = synth.kv_cache(256, 128, seed=8)
    kv[::9, 7] = 0x407F                  # MAN4's round carries into exp
    kv[::11, 8] = 0x7F7F                 # and saturates at Inf
    kv[::13, 9] = 0x7F81                 # NaN, payload in dropped planes
    W, R, KV = mod.WriteReq, mod.ReadReq, mod.KV
    wide = pmod.PrecisionView(r_m=2, d_m=4, name="wide")
    views = (pmod.FULL, pmod.MAN4, pmod.MAN0, pmod.SCORE)
    return kv, [
        [W(f"p{i}", kv[64 * i: 64 * (i + 1)], kind=KV) for i in range(3)]
        + [W("part", kv[192:229], kind=KV),
           W("w", synth.weights(3000, seed=2))],
        [R(f"p{i}", kind=KV, view=v) for i in range(3) for v in views]
        + [R("part", kind=KV, view=v) for v in views]
        + [R("w", view=v) for v in views],
        "truncate",
        [R("p1", kind=KV, view=v) for v in views + (wide,)]
        + [R("w", view=wide)],
    ]


def test_kv_views_truncation_and_partial_flush_identical_to_reference():
    out = []
    for mod, pmod in ((ttier, tprec), (rtier, rprec)):
        kw = {"device": "cpu"} if mod is ttier else {}
        dev = mod.TierStore("bitplane-kv", kv_window=64, **kw)
        kv, script = _kv_view_script(mod, pmod)
        recs = []
        for batch in script:
            if batch == "truncate":
                dev.truncate_planes(["p1", "w"], pmod.MAN4)
            else:
                recs += dev.submit(batch)
        out.append((dev, recs))
    (td, trecs), (rd, rrecs) = out
    _same_receipts(trecs, rrecs)
    _same_device(td, rd)
    # the partial window round-trips exactly at FULL; p1 at cut11 differs
    # from p1 at MAN4 (the wider read keeps the truncated block's guard)
    part = [r for r in trecs if r.key == "part" and r.op == "read"]
    np.testing.assert_array_equal(part[0].data, kv[192:229])
    assert rtier._intersect_views(rprec.PrecisionView(r_m=2, d_m=4),
                                  rprec.MAN4).name == "cut11"


def test_bitplane_kv_tier_runs_kv_delta_and_unpack_on_its_device(
        monkeypatch):
    """Writes go through the exponent-delta forward; reads unpack and
    round other blocks in one call and each group of KV windows in one
    fused unpack → inverse → round call over the slab's rows (no
    standalone inverse), all on tensors of the tier's device."""
    from repro_torch.kernels import bitplane as kbit
    from repro_torch.kernels import kv_delta as kkv

    calls = []

    def spy(name, fn):
        def wrapped(x, *args, **kw):
            calls.append((name, x.device.type, tuple(x.shape),
                          getattr(args[-1] if args else None, "name", None)))
            return fn(x, *args, **kw)
        return wrapped

    monkeypatch.setattr(kkv, "kv_forward", spy("fwd", kkv.kv_forward))
    monkeypatch.setattr(kkv, "kv_inverse", spy("inv", kkv.kv_inverse))
    monkeypatch.setattr(kbit, "unpack_planes", spy("unpack",
                                                    kbit.unpack_planes))
    monkeypatch.setattr(kbit, "unpack_kv_windows",
                        spy("kv_read", kbit.unpack_kv_windows))
    dev = ttier.TierStore("bitplane-kv", kv_window=64, device="cpu")
    kv = synth.kv_cache(128, 128, seed=9)
    dev.submit([ttier.WriteReq("a", kv, kind=ttier.KV),
                ttier.WriteReq("w", synth.weights(2048, seed=1))])
    assert calls == [("fwd", "cpu", (2, 64, 128), None)]
    calls.clear()
    recs = dev.submit([ttier.ReadReq("a", kind=ttier.KV, view=tprec.MAN4),
                       ttier.ReadReq("w", view=tprec.MAN4)])
    assert calls == [("unpack", "cpu", (14, 256), "man4"),
                     ("kv_read", "cpu", (14, 2304), "man4")]
    np.testing.assert_array_equal(
        recs[0].data, tprec.truncate_reference(kv.ravel(), tprec.MAN4)
        .reshape(kv.shape))
