"""The program's own spans (``repro_torch.spans``) in a run of a cell:
the idle gaps of the device trace named by the innermost program span
that covers each, and four per-layer numbers read from the spans and
their bytes.

    python3 portbench/program_spans.py --workload <name> --seed <n> \\
        --seconds <s> [--trace 0|1]

runs one cell as ``run.py`` does, with ``spans.record()`` open (with
``--trace 1``, the default, from the traced window's start to its end,
after the warm-up), and prints ``run.py``'s result line with the spans'
readings added: ``program_metrics`` (the four numbers below),
``program`` (spans a request, each span name's count and host seconds,
the tier's span totals beside the probe's, the span's cost on this host)
and, traced, ``breakdown.program_idle_gaps`` (the idle gaps by innermost
program span, a gap under none keeping the label ``run.py`` gives it),
the idle share under no program span or an engine call's own time, and
the marker offsets.

Each reader takes an object with ``window`` (host ns) and
``program_spans`` (the recorder's spans) and counts the spans that
started in the window:

* ``tier_emit_ms_per_mib``: ``tier.emit`` over the raw MiB on ``tier.encode``;
* ``tier_decompress_ms_per_mib``: ``tier.decompress`` over the decoded MiB
  on ``tier.read``;
* ``tier_wait_ms_per_mib``: ``tier.wait`` over the raw and decoded MiB;
* ``commit_host_ms``: the mean ``engine.commit`` inside ``engine.decode``,
  less the outermost ``tier.*`` spans inside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MIB = float(1 << 20)
# engine calls: a gap under one of these and none of its children is
# named by no finer phase
ENGINE_CALLS = ("engine.prefill", "engine.decode", "engine.retire")


def _in_window(run, name: str) -> list:
    lo, hi = run.window
    return [s for s in run.program_spans
            if s.name == name and lo <= s.start <= hi]


def _ms(spans_) -> float:
    return sum(s.end - s.start for s in spans_) / 1e6


def _mib(spans_) -> float:
    return sum(s.nbytes or 0 for s in spans_) / MIB


def tier_emit_ms_per_mib(run) -> Optional[float]:
    raw = _mib(_in_window(run, "tier.encode"))
    return _ms(_in_window(run, "tier.emit")) / raw if raw else None


def tier_decompress_ms_per_mib(run) -> Optional[float]:
    dec = _mib(_in_window(run, "tier.read"))
    return _ms(_in_window(run, "tier.decompress")) / dec if dec else None


def tier_wait_ms_per_mib(run) -> Optional[float]:
    mib = (_mib(_in_window(run, "tier.encode"))
           + _mib(_in_window(run, "tier.read")))
    return _ms(_in_window(run, "tier.wait")) / mib if mib else None


def commit_host_ms(run) -> Optional[float]:
    """Mean host ms of a decode step's commit outside the tier."""
    sp, (lo, hi) = run.program_spans, run.window
    own = {i: s.end - s.start for i, s in enumerate(sp)
           if s.name == "engine.commit" and s.parent >= 0
           and sp[s.parent].name == "engine.decode" and lo <= s.start <= hi}
    if not own:
        return None
    for s in sp:
        if s.name.startswith("tier."):
            # the outermost tier span under a commit: no tier span between
            p = s.parent
            while p >= 0 and p not in own and not sp[p].name.startswith(
                    "tier."):
                p = sp[p].parent
            if p in own:
                own[p] -= s.end - s.start
    return sum(own.values()) / len(own) / 1e6


READERS = {f.__name__: f for f in (tier_emit_ms_per_mib,
                                   tier_decompress_ms_per_mib,
                                   tier_wait_ms_per_mib, commit_host_ms)}


def depth(spans_) -> np.ndarray:
    d = np.zeros(len(spans_), np.int64)
    for i, s in enumerate(spans_):
        if s.parent >= 0:
            d[i] = d[s.parent] + 1
    return d


def idle_gaps(ev, clock, window, program: Sequence, host_phases: dict):
    """The idle gaps of the traced ``window`` (host ns): their lengths
    (ns), their middles (trace ns), each one's label (the innermost
    program span over its middle; else the first of ``host_phases`` over
    it, as ``devtrace.summarise`` names it; else ``other``), and the
    host-to-trace clock."""
    from portbench import devtrace

    to_trace, _ = clock.fit(ev)
    lo, hi = (int(x) for x in to_trace(np.asarray(window)))
    ms, me = devtrace.merge(*devtrace.clip(ev.start, ev.end, lo, hi))
    gs, ge = np.concatenate([[lo], me]), np.concatenate([ms, [hi]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    label = np.full(mid.shape, None, dtype=object)
    free = np.ones(mid.shape, bool)
    dep = depth(program)
    by_depth: Dict[int, list] = {}
    for i, s in enumerate(program):
        if s.end:
            by_depth.setdefault(int(dep[i]), []).append(s)
    for d in sorted(by_depth, reverse=True):
        # spans of one depth never overlap: sorted by start, the one
        # that starts last at or before a point is the only candidate
        level = sorted(by_depth[d], key=lambda s: s.start)
        starts = to_trace([s.start for s in level])
        ends = to_trace([s.end for s in level])
        j = np.searchsorted(starts, mid, side="right") - 1
        hit = free & (j >= 0)
        hit[hit] = mid[hit] < ends[j[hit]]
        for k in np.nonzero(hit)[0]:
            label[k] = level[j[k]].name
        free &= ~hit
    for name, spans_ in host_phases.items():
        conv = [(int(a), int(b)) for a, b in
                zip(to_trace([x for x, _ in spans_]),
                    to_trace([y for _, y in spans_]))]
        hit = free & devtrace.covered(mid, conv)
        label[hit] = name
        free &= ~hit
    label[free] = "other"
    return ge - gs, mid, label, to_trace


def label_idle(ev, clock, window, program: Sequence, host_phases: dict
               ) -> Dict[str, float]:
    """Idle seconds of the traced ``window`` by label (:func:`idle_gaps`)."""
    length, _, label, _ = idle_gaps(ev, clock, window, program, host_phases)
    return by_label(length, label)


def by_label(length, label) -> Dict[str, float]:
    idle: Dict[str, float] = {}
    for name, g in zip(label, length):
        idle[name] = idle.get(name, 0.0) + int(g) / 1e9
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def unnamed_neighbours(length, mid, label, to_trace, program: Sequence):
    """Idle seconds of the gaps no program phase names (an engine call's
    own time or no program span), by the last program span to end before
    each gap's middle and the next to start after it (where the host was
    between phases); and the longest such gaps, each as (ns, where, ns
    from the last end to its middle, ns from its middle to the next
    start)."""
    names = {s.name for s in program}
    done = sorted((s for s in program if s.end), key=lambda s: s.end)
    begun = sorted(program, key=lambda s: s.start)
    ends = to_trace([s.end for s in done])
    starts = to_trace([s.start for s in begun])
    out: Dict[str, float] = {}
    longest = []
    for g, m, name in zip(length, mid, label):
        if name in names and name not in ENGINE_CALLS:
            continue
        i = np.searchsorted(ends, m, side="right") - 1
        j = np.searchsorted(starts, m, side="left")
        key = (f"{name}: {done[i].name if i >= 0 else '-'} | "
               f"{begun[j].name if j < len(begun) else '-'}")
        out[key] = out.get(key, 0.0) + int(g) / 1e9
        longest.append((int(g), key,
                        int(m - ends[i]) if i >= 0 else None,
                        int(starts[j] - m) if j < len(begun) else None))
    return (dict(sorted(out.items(), key=lambda kv: -kv[1])[:12]),
            sorted(longest, reverse=True)[:16])


def summary(run, idle: Optional[Dict[str, float]]) -> dict:
    """Spans a request, each name's count and host seconds, the tier's
    span totals beside the probe's, and the idle share that no program
    phase names (with a trace)."""
    lo, hi = run.window
    sp = [s for s in run.program_spans if lo <= s.start <= hi]
    per_req: Dict[str, int] = {}
    host: Dict[str, list] = {}
    for s in sp:
        if s.request is not None:
            per_req[s.request] = per_req.get(s.request, 0) + 1
        h = host.setdefault(s.name, [0, 0.0])
        h[0] += 1
        h[1] += (s.end - s.start) / 1e9

    def probe_s(label):
        return sum(b - a for a, b in run.spans.get(label, [])
                   if lo <= a <= hi) / 1e9

    out = {
        "spans": len(sp),
        "spans_per_request": (float(np.mean(list(per_req.values())))
                              if per_req else None),
        "tier_encode_s": _ms(_in_window(run, "tier.encode")) / 1e3,
        "probe_tier_write_s": probe_s("tier write"),
        "tier_read_s": _ms(_in_window(run, "tier.read")) / 1e3,
        "probe_tier_read_s": probe_s("tier read"),
        "host_s": dict(sorted(host.items(), key=lambda kv: -kv[1][1])),
    }
    if idle is not None:
        names = {s.name for s in run.program_spans}
        unnamed = sum(v for k, v in idle.items()
                      if k in ENGINE_CALLS or k not in names)
        total = sum(idle.values())
        out["idle_unnamed_share"] = 100.0 * unnamed / total if total else None
    return out


def span_cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns a span costs, opened and closed empty, recording on and
    off."""
    from repro_torch import spans

    def loop():
        t = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("cost"):
                pass
        return (time.perf_counter_ns() - t) / n

    off = loop()
    with spans.record():
        on = loop()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from repro_torch import spans

    from portbench import check, devtrace, harness, registry

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 3
    cost_before = span_cost_ns()
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(registry.benchmark(), args.workload)
    traced = bool(args.trace)
    got = {}
    trace_window, summarise = devtrace.trace_window, devtrace.summarise

    def traced_window():
        got["record"] = spans.record()
        got["rec"] = got["record"].__enter__()
        return trace_window()

    def summarised(ev, clock, window, kernel_spans, host):
        got["record"].__exit__(None, None, None)
        program = got["rec"].spans
        gaps = idle_gaps(ev, clock, window, program, host)
        got["idle"] = by_label(gaps[0], gaps[2])
        got["between"], got["longest"] = unnamed_neighbours(*gaps, program)
        return summarise(ev, clock, window, kernel_spans, host)

    if traced:
        devtrace.trace_window, devtrace.summarise = traced_window, summarised
        try:
            run_, srv = harness.run(cell, args.seed, args.seconds, True,
                                    device, T_START)
        finally:
            devtrace.trace_window, devtrace.summarise = trace_window, summarise
    else:
        # the warm-up's spans are recorded too; every reading counts only
        # the spans that started in the window
        with spans.record() as got["rec"]:
            run_, srv = harness.run(cell, args.seed, args.seconds, False,
                                    device, T_START)
    run_.program_spans = got["rec"].spans
    mets = harness.metrics(cell, run_, traced)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if traced:
        info.update(busy_s=run_.trace.busy_s, window_s=run_.trace.window_s)
    params = srv.params
    srv.close()
    del srv
    torch.cuda.empty_cache()
    ok, checks = check.check(cell, run_, params, args.seed)
    line = json.loads(harness.result_line(ok, run_, mets, info, checks,
                                          traced))
    line["program_metrics"] = {name: f(run_) for name, f in READERS.items()}
    line["program"] = summary(run_, got.get("idle"))
    if traced:
        line["breakdown"]["program_idle_gaps"] = [
            [k, v] for k, v in got["idle"].items()]
        line["program"]["marker_offsets_ns"] = run_.trace.marker_offsets_ns
        line["program"]["unnamed_idle_between"] = got["between"]
        line["program"]["unnamed_idle_longest"] = got["longest"]
    line["program"]["span_cost_ns"] = {"clean": cost_before,
                                       "after_run": span_cost_ns()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
