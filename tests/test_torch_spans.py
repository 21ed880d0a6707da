"""The span recorder (``repro_torch.spans``) and the serving path's spans:
nothing is recorded unless ``spans.record()`` is open, spans nest under
the right parents and never under one of their own name, times are
``perf_counter_ns``, every span of an engine call carries its request,
the tier's spans carry the bytes its receipts count, and recording
changes no token served."""

import gc
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core.tier import make_device  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import ServeEngine, serving  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_nothing_is_recorded_unless_record_is_open():
    a, b = spans.span("x", nbytes=3), spans.span("y")
    assert a is b is spans.OFF and not a
    with spans.span("x") as sp:
        sp.nbytes = 7                      # deaf while off
        assert sp.nbytes is None
    with spans.record() as rec:
        assert spans.span("x") is not spans.OFF
        with spans.span("x"):
            pass
    assert spans.span("after") is spans.OFF
    assert [s.name for s in rec.spans] == ["x"]


def test_record_is_not_reentrant():
    with spans.record():
        with pytest.raises(RuntimeError):
            with spans.record():
                pass
    assert spans.span("x") is spans.OFF


def test_spans_nest_with_their_parents_and_requests():
    with spans.record() as rec:
        with spans.span("top", request="r7"):
            with spans.span("a", nbytes=10) as a:
                with spans.span("a") as inner:     # same name: not recorded
                    assert inner is spans.OFF
                    with spans.span("b") as b:
                        b.nbytes = 4
            with spans.span("c", request="other"):
                with spans.span("d"):
                    pass
            with spans.span("e"):
                pass
        with spans.span("outside"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["top", "a", "b", "c", "d", "e", "outside"]
    parent = {s.name: (names[s.parent] if s.parent >= 0 else None)
              for s in rec.spans}
    assert parent == {"top": None, "a": "top", "b": "a", "c": "top",
                      "d": "c", "e": "top", "outside": None}
    req = {s.name: s.request for s in rec.spans}
    assert req == {"top": "r7", "a": "r7", "b": "r7", "c": "other",
                   "d": "other", "e": "r7", "outside": None}
    assert a.nbytes == 10 and rec.spans[2].nbytes == 4
    for s in rec.spans:
        assert 0 < s.start <= s.end
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end


def test_times_are_perf_counter_ns():
    with spans.record() as rec:
        t0 = time.perf_counter_ns()
        with spans.span("x"):
            time.sleep(0.002)
        t1 = time.perf_counter_ns()
    s = rec.spans[0]
    assert t0 <= s.start and s.end <= t1 and s.ns >= 2_000_000
    assert spans.now is time.perf_counter_ns


def test_a_collection_is_a_span():
    with spans.record() as rec:
        with spans.span("x"):
            gc.collect()
    gc.collect()                                   # not recorded
    assert [s.name for s in rec.spans] == ["x", "gc"]
    assert rec.spans[1].parent == 0 and rec.spans[1].end


def test_a_failing_span_closes():
    with spans.record() as rec:
        with pytest.raises(ValueError):
            with spans.span("x"):
                raise ValueError
        with spans.span("x"):                      # reopens: x was closed
            pass
    assert [s.name for s in rec.spans] == ["x", "x"]
    assert all(s.end and s.parent == -1 for s in rec.spans)


# -- the serving path ---------------------------------------------------------

ENGINE = dict(max_seq=96, batch=2, page_tokens=16, hbm_kv_budget=1 << 12)
PROMPT, NEW = 40, 30

TOP = ("engine.prefill", "engine.decode", "engine.retire")
STEP = ("engine.prefill", "engine.decode")
PARENTS = {
    "engine.tokens_to_device": STEP,
    "engine.forward": STEP,
    "engine.logits_to_host": STEP,
    "engine.commit": STEP,
    "engine.flush_io": ("engine.commit", "engine.retire"),
    "engine.window_to_host": ("engine.commit",),
    "engine.issue_readback": ("engine.commit",),
    "engine.readback_apply": ("engine.flush_io",),
    "pool.append": ("engine.commit",),
    "pool.read_issue": ("engine.issue_readback",),
    "pool.drain": ("engine.flush_io",),
    "pool.release": ("engine.retire",),
    "engine.release_graph": ("engine.retire",),
    "tier.write": ("pool.append",),
    "tier.stage": ("tier.write",),
    "tier.encode": ("tier.write", "tier.fetch"),
    "tier.kv_transform": ("tier.encode",),
    "tier.pack": ("tier.encode",),
    "tier.prescreen": ("tier.encode",),
    "tier.match": ("tier.encode",),
    "tier.emit": ("tier.encode",),
    "tier.read": ("pool.drain", "pool.append", "pool.read_issue"),
    "tier.fetch": ("tier.read",),
    "tier.decompress": ("tier.read",),
    "tier.to_device": ("tier.read",),
    "tier.unpack": ("tier.read",),
    "tier.wait": ("tier.kv_transform", "tier.encode", "tier.match",
                  "tier.read"),
    "mla.q_lora": ("engine.forward",),
    "moe.route": ("engine.forward",),
    "moe.held": ("engine.forward",),
}


def _expected(cfg) -> set:
    """The span names a request of ``cfg`` opens: the model's own only
    where it has a query LoRA or experts."""
    names = set(PARENTS) | set(TOP)
    if not cfg.q_lora_rank:
        names.discard("mla.q_lora")
    if not cfg.n_experts:
        names -= {"moe.route", "moe.held"}
    return names


@pytest.fixture(scope="module", params=["qwen2-0.5b", "deepseek-v2-lite-16b"])
def model(request):
    cfg = smoke_config(ARCHS[request.param])
    return cfg, tm.init_params(cfg, seed=3, device="cpu")


STATS = ("link_bytes_in", "raw_bytes_stored", "dram_bytes_read")


def _serve(cfg, params, tier, index, seed):
    """One request on a fresh engine: its tokens, and what the tier's
    receipts counted from its start to its retire."""
    before = {k: getattr(tier.stats, k) for k in STATS}
    eng = ServeEngine(cfg, params, device_kind=tier, key_prefix=f"r{index}.",
                      device="cpu", **ENGINE)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab, (ENGINE["batch"], PROMPT), dtype=np.int32)
    tokens = eng.generate(prompt, NEW)
    counted = {k: getattr(tier.stats, k) - before[k] for k in STATS}
    eng.retire()
    return tokens, counted


def _total(rec, name, request):
    return sum(s.nbytes for s in rec.spans
               if s.name == name and s.request == request)


def test_engine_span_tree(model):
    cfg, params = model
    tier = make_device("trace", device="cpu")
    with spans.record() as rec:
        counted = [_serve(cfg, params, tier, i, seed=i)[1] for i in range(2)]
    names = [s.name for s in rec.spans]
    for s in rec.spans:
        assert s.end >= s.start > 0
        if s.name == "gc":              # wherever a collection falls
            continue
        if s.parent < 0:
            assert s.name in TOP, s
        else:
            assert names[s.parent] in PARENTS[s.name], (s, names[s.parent])
        p = s.parent
        while p >= 0:                   # never under a span of its name
            assert names[p] != s.name
            p = rec.spans[p].parent
    assert {s.request for s in rec.spans if s.name != "gc"} == {"r0", "r1"}
    for i, c in enumerate(counted):
        r = f"r{i}"
        mine = [s for s in rec.spans if s.request == r and s.name != "gc"]
        assert {s.name for s in mine} == _expected(cfg)
        assert [s.name for s in mine if s.parent < 0] == (
            ["engine.prefill"] + ["engine.decode"] * NEW + ["engine.retire"])
        # the tier's bytes are its receipts'
        assert _total(rec, "tier.write", r) == c["link_bytes_in"] > 0
        assert _total(rec, "tier.encode", r) == c["raw_bytes_stored"]
        assert _total(rec, "tier.fetch", r) == c["dram_bytes_read"] > 0
        # the words read back are the words written into the cache
        assert (_total(rec, "tier.read", r)
                == _total(rec, "engine.readback_apply", r) > 0)
        # every completed window left the card once
        paged = (PROMPT + NEW) // ENGINE["page_tokens"] * ENGINE["page_tokens"]
        assert _total(rec, "engine.window_to_host", r) == (
            paged * serving._kv_bytes_per_token(cfg, ENGINE["batch"]))
    assert tier.stats.raw_bytes_stored == 0


def test_recording_changes_no_token(model):
    cfg, params = model
    off = _serve(cfg, params, make_device("trace", device="cpu"), 0, 5)[0]
    with spans.record() as rec:
        on = _serve(cfg, params, make_device("trace", device="cpu"), 0, 5)[0]
    assert rec.spans
    np.testing.assert_array_equal(off, on)


def test_decode_counts_mla_layer_steps_by_path(model):
    """A request's decode steps count their MLA layers by path at retire:
    every one absorbed (one query position against the cache), none
    re-expanded, and the prefill's under neither; a model without MLA
    records neither counter."""
    cfg, params = model
    with spans.record() as rec:
        _serve(cfg, params, make_device("trace", device="cpu"), 0, 7)
    if not cfg.mla:
        assert not any(k.startswith("mla.") for k in rec.counters)
        return
    assert rec.counters["mla.absorbed_layer_steps"] == NEW * cfg.n_layers
    assert rec.counters["mla.expanded_layer_steps"] == 0
