"""The arithmetic of the metric readers (``metrics/<name>.py``), shared
where two names read the same quantity.  Each takes a
:class:`portbench.harness.Run` and returns a number, or None where the
run holds nothing to read."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import counts

MIB = float(1 << 20)


def _mean(xs: List[float]) -> Optional[float]:
    return float(np.mean(xs)) if xs else None


def _tokens_in_window(run, r) -> List[int]:
    return [t for t in r.token_times() if t <= run.window[1]]


def out_tok_s(run) -> Optional[float]:
    """Tokens served inside the window, over every sequence, a second."""
    n = sum(r.batch * len(_tokens_in_window(run, r)) for r in run.requests)
    return n / run.seconds if n else None


def ttft_mean_ms(run) -> Optional[float]:
    """Mean time from a request's due time to its prefill's logits on the
    host, over the requests whose first token came in the window."""
    return _mean([(r.first_token - r.due) / 1e6 for r in run.requests
                  if r.times and run.in_window(r.first_token)])


def itl_gaps_ms(run) -> List[float]:
    out = []
    for r in run.requests:
        tt = _tokens_in_window(run, r)
        out.extend(np.diff(np.asarray(tt, np.int64)) / 1e6)
    return out


def itl_p99_ms(run) -> Optional[float]:
    """99th percentile of the gaps between consecutive served tokens of a
    request, over the window's requests (the first gap carries the decode
    step's capture, a commit step's gap the tier's work)."""
    g = itl_gaps_ms(run)
    return float(np.percentile(g, 99)) if g else None


def prefill_ms(run) -> Optional[float]:
    """Mean host wall of a request's ``prefill`` call, to its logits on the
    host."""
    return _mean([(r.times[0] - r.prefill_start) / 1e6 for r in run.requests
                  if r.times and run.in_window(r.times[0])])


def boundary_gap_ms(run) -> Optional[float]:
    """Mean gap of the decode steps that committed a window of KV."""
    page = run.traffic["page_tokens"]
    out = []
    for r in run.requests:
        tt = _tokens_in_window(run, r)
        for s in range(1, len(tt)):
            if (r.prompt_len + s) % page == 0:
                out.append((tt[s] - tt[s - 1]) / 1e6)
    return _mean(out)


def capture_s(run) -> Optional[float]:
    """Mean host wall of a request's decode-step capture (warm-up step and
    graph capture)."""
    return _mean([(b - a) / 1e9 for a, b in run.spans_in_window("capture")])


def spill_share(run) -> Optional[float]:
    """Pages spilled to the tier over pages committed, in %."""
    committed = sum(r.pages_committed for r in run.requests)
    spilled = sum(r.pages_spilled for r in run.requests)
    return 100.0 * spilled / committed if committed else None


def _span_ms(run, label: str) -> float:
    return sum(b - a for a, b in run.spans_in_window(label)) / 1e6


def tier_write_ms_per_mib(run) -> Optional[float]:
    raw = run.tier_bytes["write_raw"]
    return _span_ms(run, "tier write") / (raw / MIB) if raw else None


def tier_read_ms_per_mib(run) -> Optional[float]:
    dec = run.tier_bytes["read_decoded"]
    return _span_ms(run, "tier read") / (dec / MIB) if dec else None


def tier_device_roofline(run) -> Optional[float]:
    """The tier's least device time (its bytes at the HBM rate) over the
    device time of the kernels launched inside its spans, in %."""
    if run.trace is None:
        return None
    b = run.tier_bytes
    least = counts.tier_least_s(
        counts.tier_write_bytes(b["write_raw"], b["write_stored"]),
        counts.tier_read_bytes(b["read_stored"], b["read_decoded"]))
    spent = sum(run.trace.span_kernel_s.values())
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def decode_replay_ms(run) -> Optional[float]:
    """Kernel time of the captured decode step a replay."""
    t = run.trace
    if t is None or not t.replays:
        return None
    return 1e3 * t.replay_kernel_s / t.replays


def idle_share(run) -> Optional[float]:
    """Share of the traced window with nothing running on the device."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run) -> Optional[float]:
    """The model's operations for every token processed in the window (the
    prompts and the decode steps; routed experts at ``top_k``, attention
    over each token's context, the head where logits are needed) over the
    window at the bf16 peak, in %."""
    conf, end = run.conf, run.window[1]
    flops = 0.0
    for r in run.requests:
        if not r.times or r.times[0] > end:
            continue
        flops += counts.prefill_flops(conf, r.batch, r.prompt_len)
        for s in range(1, len(r.times)):
            if r.times[s] <= end:
                flops += counts.decode_flops(conf, r.batch,
                                             r.prompt_len + s - 1)
    return 100.0 * flops / (run.seconds * counts.BF16_FLOPS_S) if flops \
        else None
