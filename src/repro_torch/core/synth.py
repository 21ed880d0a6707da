"""Synthetic tensor generators with LLM-like statistics, and serving
traces.

* KV cache: per-channel AR(1) time series — smooth along the token axis
  within a channel, with log-normal channel scales, a sparse set of
  outlier channels and per-channel biases, the structure Mechanism I
  exploits (paper Fig. 2).
* Weights: Gaussian with per-row scale variation, optionally on FP8 or
  INT4 value grids (Table IV's quantised bases), in BF16 containers.
* Serving traces: the request arrival processes the continuous-batching
  scheduler consumes (offered load in requests per scheduler decode
  round).

Numpy only; arrays are identical to the reference's for the same
arguments.  The BF16 and FP8 casts are written here (round to nearest
even, as ``ml_dtypes`` rounds): :func:`to_bf16_bits`,
:func:`to_fp8_e4m3_bits` and :func:`fp8_e4m3_to_f32`.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# BF16 / FP8 (E4M3, IEEE-style) casts in numpy
# ---------------------------------------------------------------------------

def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """BF16 bit patterns (uint16) of ``x`` rounded to nearest even; a
    float64 input is first cast to float32, as ``ml_dtypes`` casts it.
    NaN becomes the quiet NaN of its sign."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    r = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    r = np.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, r)
    return r.astype(np.uint16)


def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    """float32 values of BF16 bit patterns (exact)."""
    u = np.ascontiguousarray(u16, dtype=np.uint16)
    return (u.astype(np.uint32) << 16).view(np.float32)


_FP8_BIAS = 7
_FP8_NAN = 0x7C


def to_fp8_e4m3_bits(x: np.ndarray) -> np.ndarray:
    """uint8 codes of ``float32`` ``x`` in the IEEE-style E4M3 format
    (bias 7, max 240, an infinity, subnormals down to 2^-9 — not CUDA's
    E4M3FN), rounded to nearest even: magnitudes from 248 up become inf,
    NaN the quiet NaN of its sign."""
    f = np.ascontiguousarray(x, dtype=np.float32)
    u = f.view(np.uint32)
    sign = ((u >> 24) & 0x80).astype(np.uint8)
    mag = u & 0x7FFFFFFF
    e = (mag >> 23).astype(np.int64) - 127 + _FP8_BIAS   # target exponent
    m = (mag & 0x7FFFFF).astype(np.int64) | (1 << 23)   # 24-bit significand
    # normals keep 3 mantissa bits (drop 20); subnormals drop 20 + (1 - e)
    # more.  The sum of exponent and rounded significand carries as one
    # integer, so a round-up past 1.111b moves to the next binade.
    drop = 20 + np.clip(1 - e, 0, 31)
    half = np.int64(1) << (drop - 1)
    low = m & ((np.int64(1) << drop) - 1)
    q = m >> drop
    q = q + ((low > half) | ((low == half) & ((q & 1) == 1)))
    code = np.where(e >= 1, ((e - 1) << 3) + q, q)
    code = np.where(mag == 0, 0, code)
    code = np.minimum(code, 0x78)                 # past 240 + half: inf
    code = np.where(mag == 0x7F800000, 0x78, code)
    code = np.where(mag > 0x7F800000, _FP8_NAN, code)
    return (code.astype(np.uint8) | sign)


def fp8_e4m3_to_f32(codes: np.ndarray) -> np.ndarray:
    """float32 values of IEEE-style E4M3 codes (exact)."""
    c = np.asarray(codes, dtype=np.uint8).astype(np.int64)
    e, m = (c >> 3) & 0xF, c & 0x7
    mag = np.where(e == 0, m * 2.0 ** (-9),
                   (8 + m) * np.exp2(e.astype(np.float64) - _FP8_BIAS - 3))
    mag = np.where(e == 0xF, np.where(m == 0, np.inf, np.nan), mag)
    return np.where(c & 0x80, -mag, mag).astype(np.float32)


# ---------------------------------------------------------------------------
# KV and weight generators
# ---------------------------------------------------------------------------

def kv_cache(
    n_tokens: int,
    n_channels: int,
    smooth: float = 0.98,
    scale_spread: float = 1.0,
    outlier_frac: float = 0.02,
    mean_snr: float = 2.0,
    seed: int = 0,
) -> np.ndarray:
    """Token-major ``(n_tokens, n_channels)`` BF16 KV block (as uint16).

    ``mean_snr``: per-channel bias magnitude relative to the fluctuation —
    real K/V channels are not zero-mean; the bias keeps a channel's
    exponent stable across tokens, which Mechanism I's exponent delta
    exploits.
    """
    rng = np.random.default_rng(seed)
    scales = np.exp(rng.normal(0.0, scale_spread, size=n_channels))
    n_out = max(1, int(outlier_frac * n_channels))
    scales[rng.choice(n_channels, n_out, replace=False)] *= 30.0
    mu = rng.normal(0.0, mean_snr, size=n_channels) * scales
    x = np.empty((n_tokens, n_channels), dtype=np.float64)
    x[0] = rng.normal(0, 1, n_channels)
    noise = rng.normal(0, 1, size=(n_tokens, n_channels))
    for t in range(1, n_tokens):
        x[t] = smooth * x[t - 1] + np.sqrt(1 - smooth**2) * noise[t]
    x = x * scales[None, :] + mu[None, :]
    return to_bf16_bits(x)


def weights(
    n: int,
    fmt: str = "bf16",
    row: int = 4096,
    scale_spread: float = 0.3,
    seed: int = 0,
) -> np.ndarray:
    """Flat weight tensor as uint16 BF16 containers.

    ``fmt``: ``'bf16'`` | ``'fp8'`` | ``'int4'`` — quantised formats sit on
    the target format's value grid but stay in BF16 containers (an
    already-quantised checkpoint re-expanded); :func:`quantized_bits`
    gives their native bitstreams.
    """
    rng = np.random.default_rng(seed)
    rows = max(1, n // row)
    # sigma ~ 1/sqrt(fan_in) ~ 0.02 keeps block exponents clustered away
    # from power-of-two carry boundaries, which makes real checkpoints'
    # high-order exponent planes nearly constant (paper Fig. 16)
    w = rng.normal(0, 0.02, size=(rows, min(n, row)))
    w *= np.exp(rng.normal(0, scale_spread, size=(rows, 1)))
    w = w.ravel()[:n].astype(np.float32)
    if fmt == "fp8":
        w = fp8_e4m3_to_f32(to_fp8_e4m3_bits(w))
    elif fmt == "int4":
        s = np.abs(w).max() / 7.0
        w = np.clip(np.round(w / s), -8, 7) * s
    return to_bf16_bits(w)


def quantized_bits(u16_bf16: np.ndarray, fmt: str) -> np.ndarray:
    """Native bitstreams of quantised formats (Table IV's total savings):
    fp8 → uint8 codes; int4 → two nibbles packed per byte."""
    f = bf16_bits_to_f32(u16_bf16)
    if fmt == "fp8":
        return to_fp8_e4m3_bits(f)
    if fmt == "int4":
        s = np.abs(f).max() / 7.0 or 1.0
        q = (np.clip(np.round(f / s), -8, 7).astype(np.int8) + 8).astype(
            np.uint8)
        if q.size % 2:
            q = np.pad(q, (0, 1))
        return (q[0::2] << 4 | q[1::2]).astype(np.uint8)
    raise ValueError(fmt)


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
