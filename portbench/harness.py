"""One run of one cell: set-up, the measured window, the traced window's
reading, the correctness check and the result line.

The client is closed-loop: it sends a request, serves it to the end and
sends the next.  It sends for ``--seconds`` seconds, in whole pairs of
requests (``traffic.py``); the window runs from the first send to the
last retire, so that every rate is over whole requests.  A request is ``batch`` sequences of one prompt, served
by a fresh ``repro_torch.runtime.serving.ServeEngine`` on one tier device
shared by the run (as ``repro_torch.launch.serve`` serves), exactly as
``ServeEngine.generate`` does it: ``prefill``, then ``new_tokens`` greedy
``decode`` steps, then ``retire``.  The client times each call.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import devtrace, registry, traffic
from .probe import Probe, TierLog

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RequestLog:
    """One request as the client saw it; times in host ns."""

    index: int
    prompt_len: int
    new_tokens: int
    batch: int
    due: int = 0
    prefill_start: int = 0
    times: List[int] = dataclasses.field(default_factory=list)
    steps_done: int = 0             # decode steps run
    prompt: Optional[np.ndarray] = None      # (batch, prompt_len) sent
    tokens: Optional[np.ndarray] = None      # (batch, n) served
    finished: bool = False
    pages_committed: int = 0
    pages_spilled: int = 0
    tier: Optional[TierLog] = None

    @property
    def first_token(self) -> int:
        return self.times[0]

    def token_times(self) -> List[int]:
        """When each served token reached the host (the last decode
        step's logits serve no token)."""
        return self.times[:self.new_tokens]


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    conf: dict
    traffic: dict
    window: tuple                   # (start, end) host ns
    requests: List[RequestLog]
    setup_s: float
    peak_bytes: int
    spans: Dict[str, list]
    tier_bytes: Dict[str, int]
    trace: Optional[devtrace.DeviceTrace] = None

    @property
    def seconds(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self, t: int) -> bool:
        return self.window[0] <= t <= self.window[1]

    def spans_in_window(self, label: str) -> list:
        return [(a, b) for a, b in self.spans.get(label, [])
                if self.in_window(a)]


class Cell:
    """A workload's entry, configuration, traffic and limits."""

    def __init__(self, bench: dict, name: str, conf: dict, traffic_: dict,
                 limits: dict, pkg: Path = registry.PKG):
        self.bench = bench
        self.name = name
        self.entry = registry.workload(bench, name)
        self.conf = conf
        self.traffic = traffic_
        self.limits = limits
        self.pkg = pkg

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        entry = registry.workload(bench, name)
        return cls(bench, name, registry.config(bench, entry["config"]),
                   registry.traffic(entry["traffic"]), registry.limits(name))

    def program_config(self):
        from repro_torch.configs.base import ArchConfig

        return ArchConfig(**self.conf["program"])

    def reference(self):
        return registry.reference(self.conf["model_type"])


def _now() -> int:
    return time.perf_counter_ns()


def _policy(spec: dict):
    from repro_torch.core.precision import VIEWS
    from repro_torch.runtime.paging import PagePolicy

    return PagePolicy(tiers=tuple((int(n), VIEWS[v])
                                  for n, v in spec["tiers"]),
                      tail_view=VIEWS[spec["tail"]])


class Server:
    """The program under test, as the client drives it."""

    def __init__(self, cell: Cell, seed: int, device, params=None):
        import torch
        from repro_torch.core.tier import make_device

        from . import weights

        self.torch = torch
        self.cell = cell
        self.cfg = cell.program_config()
        self.t = cell.traffic
        self.seed = seed
        self.device = device
        self.params = (weights.make(self.cfg, seed, device)
                       if params is None else params)
        self.tier = make_device(self.t["tier"], shards=1, device=device)
        self.policy = _policy(self.t["policy"])
        self.probe = Probe()

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def serve(self, req: traffic.Request, record: bool = True,
              phases: Optional[dict] = None) -> RequestLog:
        """Serve ``req`` to its end; ``phases`` collects the client's host
        spans by name."""
        from repro_torch.runtime.serving import ServeEngine

        B, page = self.t["batch"], self.t["page_tokens"]
        log = RequestLog(req.index, req.prompt_len, req.new_tokens, B)
        log.due = _now()
        prompt = log.prompt = req.prompt(self.seed, B, self.cfg.vocab)
        ph = phases if phases is not None else {}

        def span(name, t0):
            ph.setdefault(name, []).append((t0, _now()))

        t0 = _now()
        eng = ServeEngine(
            self.cfg, self.params, max_seq=req.prompt_len + req.new_tokens
            + page, batch=B, page_tokens=page,
            hbm_kv_budget=self.t["hbm_kv_budget"], device_kind=self.tier,
            policy=self.policy, key_prefix=f"r{req.index}.",
            device=self.device)
        span("engine set-up", t0)
        log.tier = TierLog() if record else None
        self.probe.log, self.probe.step = log.tier, 0
        out = []
        try:
            log.prefill_start = t0 = _now()
            logits = eng.prefill(prompt)
            log.times.append(_now())
            span("prefill", t0)
            for i in range(req.new_tokens):
                nxt = logits.argmax(-1).astype(np.int32)
                out.append(nxt)
                self.probe.step = i + 1
                t0 = _now()
                logits = eng.decode(nxt.reshape(-1, 1))
                log.times.append(_now())
                span("decode step", t0)
                log.steps_done = i + 1
            log.finished = log.steps_done == req.new_tokens
            log.tokens = np.stack(out, axis=1)
            log.pages_committed = len(eng.pool.iter_pages())
            log.pages_spilled = eng.pool.spilled_pages
            self.probe.step = req.new_tokens + 1
            t0 = _now()
            eng.retire()
            self.sync()
            span("retire", t0)
        finally:
            self.probe.log = None
            del eng
        if log.tier is not None:
            log.tier.drop_resident()
        return log

    def close(self):
        self.probe.close()


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: int, warm: bool = True) -> tuple:
    """Set up, warm up (unless ``warm`` is False: a process that has
    served the cell already), serve for ``seconds``; returns ``(Run,
    Server)`` with the program's state still alive for the check."""
    import torch

    srv = Server(cell, seed, device)
    if warm:
        srv.serve(traffic.warmup(cell.traffic), record=False)
    reqs = traffic.schedule(cell.traffic)
    srv.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = clock = None
    if traced:
        prof = devtrace.trace_window()
        clock = devtrace.Clock()
    phases: Dict[str, list] = {}
    for k in srv.probe.spans:
        srv.probe.spans[k].clear()
    for k in srv.probe.bytes:
        srv.probe.bytes[k] = 0
    srv.sync()
    if clock is not None:
        clock.mark(torch)
    t0 = _now()
    deadline = t0 + int(seconds * 1e9)
    logs: List[RequestLog] = []
    while _now() < deadline:
        for r in reqs[len(logs) // 2 % len(reqs)]:
            req = traffic.Request(len(logs), r.prompt_len, r.new_tokens)
            logs.append(srv.serve(req, phases=phases))
    if logs:
        logs[0].due = t0
    t1 = _now()
    if clock is not None:
        clock.mark(torch)
    srv.sync()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = None
    if traced:
        t_read = time.perf_counter()
        ev = devtrace.close(prof)
        tier_spans = {k: srv.probe.spans[k] for k in ("tier write",
                                                      "tier read")}
        host = {"tier read": srv.probe.spans["tier read"],
                "tier write": srv.probe.spans["tier write"],
                "capture": srv.probe.spans["capture"]}
        host.update(phases)
        trace = devtrace.summarise(ev, clock, (t0, t1), tier_spans, host)
        log(f"trace read in {time.perf_counter() - t_read:.1f} s: "
            f"{trace.n_events} device operations, marker offsets "
            f"{trace.marker_offsets_ns} ns, {trace.replays} graph replays")
        del ev, prof
    spans = {k: list(v) for k, v in srv.probe.spans.items()}
    spans.update(phases)
    return Run(conf=cell.conf, traffic=cell.traffic, window=(t0, t1),
               requests=logs, setup_s=(t0 - t_start) / 1e9, peak_bytes=peak,
               spans=spans, tier_bytes=dict(srv.probe.bytes),
               trace=trace), srv


def metrics(cell: Cell, run_: Run, traced: bool) -> Dict[str, dict]:
    """The cell's metrics for this run, each read by its own reader; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in registry.cell_metrics(cell.bench, cell.name, traced):
        value = registry.metric_reader(m["name"], cell.pkg).read(run_)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (default: ``sys.modules``) of JAX or of the JAX
    package, by top-level name compared whole."""
    top = {n.split(".")[0] for n in list(sys.modules if names is None
                                         else names)}
    return sorted(top.intersection(FORBIDDEN))


def result_line(correct: bool, run_: Run, mets: dict, device_info: dict,
                checks: List[tuple], traced: bool) -> str:
    attempted = len(run_.requests)
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": mets, "device": device_info}
    if traced and run_.trace is not None:
        out["breakdown"] = {"device_ops": run_.trace.top_ops,
                            "idle_gaps": run_.trace.idle_by_host}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def main(args, t_start: int) -> int:
    import torch

    bench = registry.benchmark()
    cell = Cell.load(bench, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count() = "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    from . import check

    device = torch.device("cuda", 0)
    run_, srv = run(cell, args.seed, args.seconds, bool(args.trace), device,
                    t_start)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if args.trace:
        info["busy_s"] = run_.trace.busy_s
        info["window_s"] = run_.trace.window_s
    mets = metrics(cell, run_, bool(args.trace))
    log(f"window {run_.seconds:.3f} s: {len(run_.requests)} requests, "
        f"{sum(r.finished for r in run_.requests)} finished; set-up "
        f"{run_.setup_s:.3f} s")
    params = srv.params
    srv.close()
    del srv
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ok, checks = check.check(cell, run_, params, args.seed)
    log(f"check took {time.perf_counter() - t_check:.1f} s")
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    print(result_line(ok, run_, mets, info, checks, bool(args.trace)),
          flush=True)
    return 0

