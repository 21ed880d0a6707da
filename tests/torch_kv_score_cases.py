"""Inputs for the page-scoring and KV-forward tests of the port (CPU and
card): numpy only, so the card tests can build them without JAX.

* :func:`score_case` — ``(pages, valid, digest)``: ``(P, T, C)`` uint16
  bf16 patterns, ``(P,)`` int32 valid rows, ``(C,)`` f32 digest, with an
  empty page, NaN and +inf in valid rows, pages whose only NaN and inf
  lie past ``valid``, and two byte-identical pages;
* :func:`kv_case` — ``(B, n, C)`` uint16 windows shaped like KV pages
  (per-channel scales, NaN/Inf/zero specials) with the histogram's
  edges: a many-way tie, a channel whose exponents are all distinct, a
  tie between exponents 0 and 255, and a channel of one exponent.

Both are made from a seed.  The shape lists name what each test set runs:
the served and long-context shapes and the edges of P, T, C and n.
"""

import numpy as np

NAN, POS_INF = 0x7FC0, 0x7F80

# Page scoring (P, T, C): the served gather (64 candidate pages of 64
# rows, 128 channels), the long-context one (2048 pages), P above the
# card's SM count with T a multiple of no row group, P past what a full
# persistent grid keeps per cluster, and the channel edges.
SCORE_SHAPES_CARD = [(64, 64, 128), (2048, 64, 128), (300, 13, 128),
                     (140000, 1, 8), (5, 7, 1), (6, 9, 40), (3, 5, 1000),
                     (3, 4, 1024), (7, 33, 24)]
SCORE_SHAPES_CPU = [(9, 13, 128), (5, 7, 1), (6, 9, 40), (3, 5, 1000),
                    (3, 4, 1024), (7, 33, 24)]

# KV forward (B, n, C): the served flush, the long-context one, n at the
# edges of a token group and of the tile (256) and past it, B from 1 to
# 2048, and the channel edges.
KV_SHAPES_CARD = ([(128, 64, 128), (2048, 64, 128)]
                  + [(B, n, 128) for B in (1, 2048)
                     for n in (1, 17, 37, 64, 255, 256)]
                  + [(3, 64, 1), (5, 37, 40), (2, 17, 1000), (2, 64, 1024),
                     (3, 300, 40), (1, 1000, 8)])
KV_SHAPES_CPU = ([(2, n, 40) for n in (1, 17, 37, 64, 255, 256)]
                 + [(3, 64, 1), (5, 37, 40), (2, 17, 1000), (2, 64, 1024),
                    (3, 300, 40), (1, 1000, 8)])


def bf16(x) -> np.ndarray:
    """f32 -> bf16 bit patterns (truncation)."""
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def score_case(P: int, T: int, C: int, seed: int = 0):
    """Pages, valid counts and digest; the edge pages where P allows:
    0 empty, 1 NaN in a valid row, 2 +inf in a valid row, 3 and 4 NaN /
    +inf only past valid, 6 a copy of 5."""
    rng = np.random.default_rng(seed)
    pages = bf16(rng.standard_normal((P, T, C)) * 0.7)
    valid = rng.integers(0, T + 1, P).astype(np.int32)
    digest = rng.standard_normal(C).astype(np.float32)
    edges = [(0, 0, None, None), (1, T, 0, NAN), (2, T, T - 1, POS_INF),
             (3, T - 1, T - 1, NAN), (4, T - 1, T - 1, POS_INF)]
    for p, v, row, pat in edges:
        if p < P:
            valid[p] = v
            if row is not None:
                pages[p, row, C - 1] = pat
    if P > 6:
        pages[6], valid[6] = pages[5], valid[5]
    return pages, valid, digest


def _words(rng, exps) -> np.ndarray:
    """Words of the given exponents with random sign and mantissa."""
    exps = np.asarray(exps, np.uint16)
    sign = rng.integers(0, 2, exps.shape).astype(np.uint16) << 15
    mant = rng.integers(0, 128, exps.shape).astype(np.uint16)
    return sign | (exps << 7) | mant


def kv_case(B: int, n: int, C: int, seed: int = 0) -> np.ndarray:
    """(B, n, C) uint16 windows with the mode's edges in window 0 (and
    the last window): channel 0 a many-way tie (won by its smallest
    exponent, which is not counted first), channel 1 all exponents
    distinct (as far as 256 allow), channel 2 exponents 0 and 255
    equally often, the last channel of the last window one exponent."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, n, C)) * np.exp(rng.uniform(-3, 3, C))
    u = bf16(f)
    flat = u.reshape(-1)
    for k, pat in enumerate((0x7F81, 0xFF80, 0x7F80, 0x407F, 0x7F7F,
                             0xFFC1, 0x0000, 0x8000)):
        flat[k::97 - 4 * k] = pat
    if n >= 4:
        k = max(2, min(16, n // 4))
        per = n // k
        tied = rng.permutation(np.arange(100, 100 + 2 * k, 2))
        exps = np.concatenate([np.repeat(tied, per),
                               np.arange(200, 200 + n - k * per)])
        u[0, :, 0] = _words(rng, rng.permutation(exps))
    if C >= 2:
        exps = rng.permutation(256)[: min(n, 256)]
        u[0, :, 1] = _words(rng, np.resize(exps, n))
    if C >= 3 and n >= 2:
        half = n // 2
        exps = np.r_[np.zeros(half, np.int64), np.full(half, 255),
                     rng.integers(1, 255, n - 2 * half)]
        u[0, :, 2] = _words(rng, rng.permutation(exps))
    if B > 1 or C > 3:
        u[B - 1, :, C - 1] = _words(rng, np.full(n, 131))
    return u


def tie_winner(n: int) -> int:
    """The modal exponent of window 0, channel 0 of :func:`kv_case`."""
    return 100 if n >= 4 else -1
