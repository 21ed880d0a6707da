"""Synthetic serving traces: the request arrival processes the
continuous-batching scheduler consumes (offered load in requests per
scheduler decode round).

Numpy only; arrays are identical to the reference's for the same
arguments.  The reference's KV and weight generators are not ported yet
(``ROADMAP.md`` Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """``n`` sorted arrival times of a Poisson process at ``rate``
    requests per scheduler decode round (i.i.d. exponential gaps of mean
    ``1/rate``), starting near 0."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, burst: int = 4,
                    seed: int = 0) -> np.ndarray:
    """``n`` arrival times in Poisson-spaced bursts of ``burst``
    simultaneous requests; bursts arrive at ``rate / burst``, so the mean
    offered load matches :func:`poisson_arrivals` at the same ``rate``."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    n_bursts = -(-n // burst)
    starts = poisson_arrivals(n_bursts, rate / burst, seed=seed)
    return np.repeat(starts, burst)[:n]


def request_trace(
    n_requests: int,
    vocab: int,
    rate: float = 0.25,
    kind: str = "poisson",
    prompt_len: int = 32,
    new_tokens: int = 8,
    batch: int = 1,
    burst: int = 4,
    seed: int = 0,
    share_prefix_len: int = 0,
) -> list:
    """Synthetic serving trace: one dict per request, sorted by arrival,
    with the fields :class:`repro_torch.runtime.serving.ServeRequest`
    takes — ``arrival`` (scheduler decode rounds), ``prompt`` (``(batch,
    prompt_len)`` int32), ``max_new_tokens`` and a per-request ``seed``.
    ``kind`` is ``"poisson"`` or ``"bursty"``.  ``share_prefix_len > 0``
    models a common system prompt: the first ``share_prefix_len`` tokens
    are drawn once and repeated in every prompt."""
    if kind == "poisson":
        arrivals = poisson_arrivals(n_requests, rate, seed=seed)
    elif kind == "bursty":
        arrivals = bursty_arrivals(n_requests, rate, burst=burst, seed=seed)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    if not 0 <= share_prefix_len <= prompt_len:
        raise ValueError(
            f"share_prefix_len={share_prefix_len} must be within "
            f"[0, prompt_len={prompt_len}]")
    rng = np.random.default_rng(seed + 1)
    head = rng.integers(0, vocab, (batch, share_prefix_len)).astype(np.int32)
    return [
        {
            "arrival": float(t),
            "prompt": np.concatenate(
                [head, rng.integers(
                    0, vocab, (batch, prompt_len - share_prefix_len)
                ).astype(np.int32)], axis=1),
            "max_new_tokens": new_tokens,
            "seed": seed + 1000 + i,
        }
        for i, t in enumerate(arrivals)
    ]
