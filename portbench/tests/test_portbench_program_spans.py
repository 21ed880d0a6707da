"""The program's spans in the harness (``portbench/program_spans.py``):
the four readers on synthetic spans, the idle gaps named by the innermost
program span (a gap under none keeps the label the trace summary gives
it), and the tiny cells served with ``spans.record()`` open, where every
reader reads a number and the tier's spans carry the probe's bytes."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch = pytest.importorskip("torch")

from portbench import devtrace, harness  # noqa: E402
from portbench import program_spans as ps  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from repro_torch import spans  # noqa: E402

MS, MIB = 1_000_000, 1 << 20


def _span(name, start, end, parent=-1, nbytes=None, request="r0"):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           nbytes=nbytes, request=request)


def _synthetic():
    sp = [
        _span("engine.decode", 0, 100 * MS),                      # 0
        _span("engine.commit", 10 * MS, 90 * MS, 0),              # 1
        _span("tier.write", 20 * MS, 50 * MS, 1, 4 * MIB),        # 2
        _span("tier.encode", 21 * MS, 49 * MS, 2, 4 * MIB),       # 3
        _span("tier.emit", 30 * MS, 38 * MS, 3, MIB),             # 4
        _span("tier.wait", 22 * MS, 24 * MS, 3, MIB),             # 5
        _span("tier.read", 60 * MS, 80 * MS, 1, 2 * MIB),         # 6
        _span("tier.decompress", 61 * MS, 71 * MS, 6, MIB),       # 7
        _span("tier.wait", 72 * MS, 75 * MS, 6, 2 * MIB),         # 8
        _span("engine.prefill", 200 * MS, 300 * MS, -1),          # 9
        _span("engine.commit", 210 * MS, 290 * MS, 9),            # 10
        _span("tier.emit", 2000 * MS, 2010 * MS, -1),             # 11: late
    ]
    return SimpleNamespace(window=(0, 1000 * MS), program_spans=sp)


def test_readers_on_synthetic_spans():
    run = _synthetic()
    # emit 8 ms over the 4 raw MiB encoded; the late emit is outside
    assert ps.tier_emit_ms_per_mib(run) == pytest.approx(2.0)
    assert ps.tier_decompress_ms_per_mib(run) == pytest.approx(5.0)
    assert ps.tier_wait_ms_per_mib(run) == pytest.approx(5.0 / 6)
    # one commit inside a decode step: 80 ms less the tier's 30 + 20
    assert ps.commit_host_ms(run) == pytest.approx(30.0)
    empty = SimpleNamespace(window=(0, 1), program_spans=[])
    assert all(f(empty) is None for f in ps.READERS.values())


def test_idle_gaps_are_named_by_the_innermost_program_span():
    # device busy [1000,1100], [5000,5200], [9000,9100]; trace = host + 1000
    ev = devtrace.Events(
        names=["spin_kernel", "pack", "spin_kernel"],
        start=np.array([1000, 5000, 9000]), end=np.array([1100, 5200, 9100]),
        corr=np.array([1, 2, 3]),
        runtime={1: ("cudaLaunchKernel", 1000), 2: ("cudaLaunchKernel", 4900),
                 3: ("cudaLaunchKernel", 9000)})
    clock = devtrace.Clock()
    clock.marks, clock.est = [0, 8000], 900
    program = [_span("engine.decode", 0, 3500),
               _span("engine.commit", 100, 3000, 0),
               _span("tier.wait", 500, 2000, 1)]
    idle = ps.label_idle(ev, clock, (0, 9000), program,
                         {"decode step": [(0, 6000)]})
    # gaps (trace ns) [1100,5000], [5200,9000], [9100,10000]: the first's
    # middle (host 2050) lies in the commit, past the wait (to 2000); the
    # others' (host 6100, 8550) under no program span or phase
    assert idle == {"engine.commit": pytest.approx(3900e-9),
                    "other": pytest.approx(4700e-9)}
    # a gap under no program span keeps the phase's label
    idle = ps.label_idle(ev, clock, (0, 9000), program,
                         {"decode step": [(0, 7000)]})
    assert idle == {"engine.commit": pytest.approx(3900e-9),
                    "decode step": pytest.approx(3800e-9),
                    "other": pytest.approx(900e-9)}
    # the unnamed gaps by the phases around them (host 6100, 8550: after
    # the decode step, before nothing)
    gaps = ps.idle_gaps(ev, clock, (0, 9000), program, {})
    between, longest = ps.unnamed_neighbours(*gaps, program)
    assert longest == [(3800, "other: engine.decode | -", 2600, None),
                       (900, "other: engine.decode | -", 5050, None)]
    assert between == {"other: engine.decode | -": pytest.approx(4700e-9)}
    program[2].end = 2100                   # now covers the first gap's middle
    idle = ps.label_idle(ev, clock, (0, 9000), program, {})
    assert set(idle) == {"tier.wait", "other"}
    # the trace summary's own labels are unchanged
    t = devtrace.summarise(ev, clock, (0, 9000), {},
                           {"decode step": [(0, 7000)]})
    assert dict(t.idle_by_host)["decode step"] == pytest.approx(7700e-9)


@pytest.mark.parametrize("model", [tiny.QWEN, tiny.DEEPSEEK])
def test_tiny_cells_with_recording_on(model):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = tiny.cell(model)
        with spans.record() as rec:
            run, srv = harness.run(cell, 2147483659, 1.0, False,
                                   torch.device("cpu"), time.perf_counter_ns())
        srv.close()
    finally:
        torch.set_num_threads(n)
    run.program_spans = rec.spans
    got = {name: f(run) for name, f in ps.READERS.items()}
    assert all(v is not None and v > 0 for v in got.values()), got
    s = ps.summary(run, {"engine.decode": 1.0, "tier.emit": 3.0})
    assert s["idle_unnamed_share"] == pytest.approx(25.0)
    assert s["spans_per_request"] > 0
    assert s["host_s"]["engine.decode"][0] == sum(
        len(r.times) - 1 for r in run.requests)
    # the program's tier spans wrap what the probe's wrap, and count the
    # bytes its receipts count
    assert 0 < s["tier_encode_s"] <= s["probe_tier_write_s"]
    assert 0 < s["tier_read_s"] <= s["probe_tier_read_s"]
    lo, hi = run.window
    inside = [x for x in rec.spans if lo <= x.start <= hi]
    assert sum(x.nbytes for x in inside if x.name == "tier.encode") == \
        run.tier_bytes["write_raw"]
    assert sum(x.nbytes for x in inside if x.name == "tier.read") == \
        run.tier_bytes["read_decoded"]
    assert {x.request for x in inside if x.name != "gc"} == {
        f"r{r.index}" for r in run.requests}
