"""The device's side of a traced window, from ``torch.profiler``'s raw
Kineto events (CUDA activity only: tracing every CPU op of a window costs
minutes to post-process): which operations ran on the card and when, the
CUDA runtime calls that launched them (linked by correlation id), and
from those the window's busy time, each graph replay's kernel time, the
kernels launched inside host spans, and the idle gaps by what the host
was doing.

Host spans are taken with ``time.perf_counter_ns``; the trace's clock is
tied to it by a marker kernel (``torch.cuda._sleep``) launched at a known
host time at each end of the window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

MARKER = "spin_kernel"
NAME_CHARS = 160             # a kernel's name in the breakdown, cut
GRAPH_LAUNCH = "cudaGraphLaunch"


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Events:
    """A trace's device operations (name, start, end, correlation id) and
    its runtime calls (correlation id -> (name, start)); times in the
    trace's nanoseconds."""

    names: List[str]
    start: np.ndarray
    end: np.ndarray
    corr: np.ndarray
    runtime: Dict[int, Tuple[str, int]]

    @classmethod
    def from_kineto(cls, events) -> "Events":
        names, start, end, corr, runtime = [], [], [], [], {}
        for e in events:
            if "CUDA" in str(e.device_type()):
                s = e.start_ns()
                names.append(e.name())
                start.append(s)
                end.append(s + e.duration_ns())
                corr.append(e.correlation_id())
            else:
                name = e.name()
                if name.startswith("cuda"):
                    runtime[e.correlation_id()] = (name, e.start_ns())
        return cls(names, np.asarray(start, np.int64),
                   np.asarray(end, np.int64), np.asarray(corr, np.int64),
                   runtime)

    def launch_times(self) -> np.ndarray:
        """Each operation's launching runtime call's start (-1 where the
        trace has none)."""
        return np.asarray([self.runtime.get(int(c), ("", -1))[1]
                           for c in self.corr], np.int64)


class Clock:
    """Host ``perf_counter_ns`` -> trace nanoseconds, from marker kernels
    launched at known host times (:meth:`mark`)."""

    def __init__(self):
        self.marks: List[int] = []
        # the trace's clock is the wall clock: its offset, to pair marks
        self.est = time.time_ns() - time.perf_counter_ns()

    def mark(self, torch):
        """Launch a marker kernel and note the host time of its launch."""
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)

    def offsets(self, ev: Events) -> List[int]:
        """Trace time minus host time at each marker found, each launch
        paired with the mark nearest to it by the wall clock's offset (a
        lost marker loses its pair only)."""
        idx = [i for i, n in enumerate(ev.names) if MARKER in n]
        launches = sorted(ev.runtime[int(ev.corr[i])][1] for i in idx
                          if int(ev.corr[i]) in ev.runtime)
        if not self.marks:
            return []
        return [t - min(self.marks, key=lambda h: abs(t - h - self.est))
                for t in launches]

    def fit(self, ev: Events):
        """A function host ns -> trace ns (the mean marker offset, or the
        wall clock's offset when the trace holds no marker)."""
        offs = self.offsets(ev)
        off = int(np.mean(offs)) if offs else self.est
        return lambda host_ns: np.asarray(host_ns, np.int64) + off, offs


def merge(start: np.ndarray, end: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Union of intervals, sorted and disjoint."""
    if start.size == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    groups = np.cumsum(new) - 1
    ms = s[new]
    me = np.zeros(ms.size, np.int64)
    np.maximum.at(me, groups, e)
    return ms, me


def clip(s: np.ndarray, e: np.ndarray, lo: int, hi: int):
    s, e = np.maximum(s, lo), np.minimum(e, hi)
    keep = e > s
    return s[keep], e[keep]


def covered(points: np.ndarray, spans: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Which of ``points`` lie inside one of ``spans`` (disjoint)."""
    if not len(spans):
        return np.zeros(points.shape, bool)
    sp = np.asarray(sorted(spans), np.int64)
    i = np.searchsorted(sp[:, 0], points, side="right") - 1
    ok = i >= 0
    out = np.zeros(points.shape, bool)
    out[ok] = points[ok] < sp[i[ok], 1]
    return out


@dataclasses.dataclass
class DeviceTrace:
    """What the readers take from a traced window."""

    window_s: float
    busy_s: float
    replays: int
    replay_kernel_s: float
    span_kernel_s: Dict[str, float]
    top_ops: List[list]
    idle_by_host: List[list]
    marker_offsets_ns: List[int]
    n_events: int


def summarise(ev: Events, clock: Clock, window: Tuple[int, int],
              kernel_spans: Dict[str, List[Tuple[int, int]]],
              host_phases: Dict[str, List[Tuple[int, int]]]) -> DeviceTrace:
    """``window``: host ns.  ``kernel_spans``: host spans whose launched
    kernels are summed by label.  ``host_phases``: host spans, innermost
    first, that name the idle gaps (a gap under none is ``other``)."""
    to_trace, offs = clock.fit(ev)
    lo, hi = (int(x) for x in to_trace(np.asarray(window)))
    s, e = clip(ev.start, ev.end, lo, hi)
    ms, me = merge(s, e)
    busy = int((me - ms).sum())
    inside = (ev.start >= lo) & (ev.start < hi)
    dur = ev.end - ev.start
    launch = ev.launch_times()
    graph = np.asarray([ev.runtime.get(int(c), ("",))[0].startswith(
        GRAPH_LAUNCH) for c in ev.corr], bool)
    replays = sum(1 for name, t in ev.runtime.values()
                  if name.startswith(GRAPH_LAUNCH) and lo <= t < hi)
    kernel = np.asarray([not _is_copy(n) for n in ev.names], bool)
    span_s = {}
    for label, spans in kernel_spans.items():
        conv = [(int(a), int(b)) for a, b in
                zip(to_trace([x for x, _ in spans]),
                    to_trace([y for _, y in spans]))]
        sel = inside & kernel & (launch >= 0) & covered(launch, conv)
        span_s[label] = float(dur[sel].sum()) / 1e9
    by_name: Dict[str, int] = {}
    for i in np.nonzero(inside)[0]:
        by_name[ev.names[i]] = by_name.get(ev.names[i], 0) + int(dur[i])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps inside the window, named by the host span at their middle
    gs = np.concatenate([[lo], me])
    ge = np.concatenate([ms, [hi]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    label = np.full(mid.shape, "other", dtype=object)
    free = np.ones(mid.shape, bool)
    for name, spans in host_phases.items():
        conv = [(int(a), int(b)) for a, b in
                zip(to_trace([x for x, _ in spans]),
                    to_trace([y for _, y in spans]))]
        hit = free & covered(mid, conv)
        label[hit] = name
        free &= ~hit
    idle: Dict[str, int] = {}
    for name, g in zip(label, ge - gs):
        idle[name] = idle.get(name, 0) + int(g)
    idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(
        window_s=(hi - lo) / 1e9, busy_s=busy / 1e9, replays=replays,
        replay_kernel_s=float(dur[inside & graph & kernel].sum()) / 1e9,
        span_kernel_s=span_s,
        top_ops=[[n[:NAME_CHARS], v / 1e9] for n, v in top],
        idle_by_host=[[n, v / 1e9] for n, v in idle_top],
        marker_offsets_ns=offs, n_events=len(ev.names))


def trace_window():
    """A started ``torch.profiler`` over CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def close(prof) -> Events:
    prof.__exit__(None, None, None)
    return Events.from_kineto(prof.profiler.kineto_results.events())
