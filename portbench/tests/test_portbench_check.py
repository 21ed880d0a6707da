"""The correctness check must fail the control and every fault the cells
can have, at a size the CPU holds: the harness's look for a chip skipped,
the rest of a run driven with the timed path broken underneath.

On the chip the control is read at the cells' own size by
``portbench/control.py``; PERF.md gives those readings and the limits set
from them."""

import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch = pytest.importorskip("torch")

from portbench import check, harness  # noqa: E402
from portbench.tests import tiny  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(model, seed, seconds=1.0, **traffic):
    cell = tiny.cell(model, **traffic)
    run, srv = harness.run(cell, seed, seconds, False, CPU,
                           time.perf_counter_ns())
    params = srv.params
    srv.close()
    return cell, run, params


def _checked(model, seed, **traffic):
    cell, run, params = _run(model, seed, **traffic)
    ok, checks = check.check(cell, run, params, seed)
    return ok, {n: v for n, v, _ in checks}


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_float8_control_is_not_correct(model, seed):
    """The reference in float8 put in the program's place: its tokens are
    the ones served."""
    cell, run, params = _run(model, seed)
    for r in check.sample(run.requests, seed,
                          cell.traffic["check"]["sampled_requests"]):
        sched = check.spill_schedule(cell, r)
        ctl = check.reference_logits(cell, params, r, sched, "fp8")
        r.tokens = ctl.argmax(-1).numpy().astype(np.int32)
    ok, checks = check.check(cell, run, params, seed)
    assert not ok, checks


def test_token_altered_where_produced(monkeypatch):
    from repro_torch.runtime.serving import ServeEngine

    raw = ServeEngine.decode
    calls = [0]

    def decode(self, tokens):
        logits = raw(self, tokens)
        calls[0] += 1
        if self.pos == self.cache_prompt + 3:
            logits[0] = -logits[0]
        return logits

    def prefill(self, tokens):
        self.cache_prompt = tokens.shape[1]
        return raw_prefill(self, tokens)

    raw_prefill = ServeEngine.prefill
    monkeypatch.setattr(ServeEngine, "decode", decode)
    monkeypatch.setattr(ServeEngine, "prefill", prefill)
    ok, v = _checked(tiny.QWEN, 21)
    assert calls[0] and not ok and \
        v["gap_mean"] > tiny.LIMITS[tiny.QWEN]["gap_mean"], v


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_decode_step_leaves_its_state_unchanged(monkeypatch, model):
    """The decode step writes no K/V (or latent) into the cache."""
    from repro_torch.models import layers

    raw = layers._write_at

    def write_at(buf, cache_pos, new):
        if new.shape[1] > 1:
            raw(buf, cache_pos, new)

    monkeypatch.setattr(layers, "_write_at", write_at)
    ok, v = _checked(model, 22)
    assert not ok, v


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_half_the_batch_left_out(monkeypatch, model):
    """The decode step computes the first half of the batch and hands its
    rows to the rest."""
    from repro_torch.runtime.serving import ServeEngine

    raw = ServeEngine._decode_logits

    def decode_logits(self, tokens):
        out = raw(self, tokens).clone()
        half = out.shape[0] // 2
        out[half:] = out[:out.shape[0] - half]
        return out

    monkeypatch.setattr(ServeEngine, "_decode_logits", decode_logits)
    ok, v = _checked(model, 23)
    assert not ok, v


# a policy under which most spilled pages come back below bf16, so that a
# readback left out changes the cache (the tiny deepseek cell spills too
# few pages a layer for the paper's policy to reach man4)
LOSSY = {"tiers": [[1, "bf16"], [1, "man4"]], "tail": "man0"}


@pytest.mark.parametrize("policy", [None, LOSSY], ids=["paper", "lossy"])
@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_sound_run_is_correct(model, policy):
    """The program as it is: every spilled page's cache slots hold its
    view at the step after its issue."""
    ok, v = _checked(model, 29, **({"policy": policy} if policy else {}))
    assert ok and v["tier_words_off"] == 0 == v["tier_pages_off"], v


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_readback_never_reaches_the_cache(monkeypatch, model):
    """Spilled pages come back from the tier but are not written into the
    cache: the decode attends to the words it committed, and the cache's
    slots after the readback differ from the view."""
    from repro_torch.runtime.serving import ServeEngine

    monkeypatch.setattr(ServeEngine, "_apply_readback",
                        lambda self, pages, data: None)
    ok, v = _checked(model, 24, policy=LOSSY)
    assert not ok and v["tier_words_off"] > 0, v


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_readback_skipped(monkeypatch, model):
    """The readbacks in flight are drained from the tier and dropped: no
    spilled page is ever written back."""
    from repro_torch.runtime.serving import ServeEngine

    def flush_io(self):
        inflight, self._inflight = self._inflight, []
        if inflight:
            self.pool.drain_reads([t for _, t in inflight])

    monkeypatch.setattr(ServeEngine, "flush_io", flush_io)
    ok, v = _checked(model, 27, policy=LOSSY)
    assert not ok and v["tier_words_off"] > 0, v


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_readback_a_step_late(monkeypatch, model):
    """Each boundary's readbacks are written into the cache one boundary
    later than issued."""
    from repro_torch.runtime.serving import ServeEngine

    raw = ServeEngine.flush_io

    def flush_io(self):
        late = getattr(self, "_late", [])
        self._late, self._inflight = self._inflight, late
        raw(self)

    def retire(self):
        raw(self)
        raw(self)
        return raw_retire(self)

    raw_retire = ServeEngine.retire
    monkeypatch.setattr(ServeEngine, "flush_io", flush_io)
    monkeypatch.setattr(ServeEngine, "retire", retire)
    ok, v = _checked(model, 28, policy=LOSSY)
    assert not ok and v["tier_words_off"] > 0, v


def test_tier_answer_altered(monkeypatch):
    """The tier returns a page with one word off."""
    from repro_torch.runtime.paging import KVPagePool

    raw = KVPagePool.drain_reads

    def drain_reads(self, tickets):
        data = raw(self, tickets)
        if data:
            data[0] = data[0].copy()
            data[0].flat[0] ^= 1
        return data

    monkeypatch.setattr(KVPagePool, "drain_reads", drain_reads)
    ok, v = _checked(tiny.QWEN, 25)
    assert not ok and v["tier_words_off"] > 0, v


def test_a_run_that_finishes_nothing_is_not_correct():
    cell = tiny.cell(tiny.QWEN)
    run, srv = harness.run(cell, 26, 0.0, False, CPU, time.perf_counter_ns())
    params = srv.params
    srv.close()
    ok, v = check.check(cell, run, params, 26)
    assert not ok, v
