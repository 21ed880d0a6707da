"""KV-specific transform — Mechanism I (paper §III-B, Fig. 8).

The host writes KV token-major; TRACE buffers a window of ``n`` tokens,
transposes to channel-major groups and replaces each element's exponent
with a zigzagged delta (mod 256, so always invertible) against the
channel's modal exponent ``beta_j`` before bit-plane packing.

The transformed element keeps the BF16 container layout:
    bit 15   sign            (unchanged)
    bits14..7 zigzag(exp - beta_j)
    bits 6..0 mantissa        (unchanged)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bitplane import EXP_BITS, EXP_LO

_EXP_MASK = np.uint16(((1 << EXP_BITS) - 1) << EXP_LO)
_REST_MASK = np.uint16(~(((1 << EXP_BITS) - 1) << EXP_LO) & 0xFFFF)


@dataclasses.dataclass
class KVBlockMeta:
    """Constant-size per-block state needed to invert the transform."""

    beta: np.ndarray      # (C,) uint8 — per-channel base exponent
    n_tokens: int
    n_channels: int


def _zigzag_u8(d: np.ndarray) -> np.ndarray:
    """Signed int8-range deltas (given mod 256 as uint8) → small unsigned
    codes: 0,-1,1,-2,… → 0,1,2,3,…"""
    s = d.astype(np.int16)
    s = np.where(s >= 128, s - 256, s)
    z = np.where(s >= 0, 2 * s, -2 * s - 1)
    return z.astype(np.uint8)


def _unzigzag_u8(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.int16)
    s = np.where(z % 2 == 0, z // 2, -(z + 1) // 2)
    return (s % 256).astype(np.uint8)


def kv_forward(block_u16: np.ndarray) -> tuple[np.ndarray, KVBlockMeta]:
    """Token-major (n, C) uint16 → channel-major transformed flat uint16
    (all tokens of channel 0, then channel 1, …) plus the block metadata."""
    n, C = block_u16.shape
    cm = np.ascontiguousarray(block_u16.T)
    exp = ((cm & _EXP_MASK) >> EXP_LO).astype(np.uint8)
    beta = np.empty(C, dtype=np.uint8)
    for j in range(C):
        beta[j] = np.bincount(exp[j], minlength=256).argmax()
    delta = (exp.astype(np.int16) - beta[:, None].astype(np.int16)) % 256
    z = _zigzag_u8(delta.astype(np.uint8))
    out = (cm & _REST_MASK) | (z.astype(np.uint16) << EXP_LO)
    return out.ravel(), KVBlockMeta(beta=beta, n_tokens=n, n_channels=C)


def kv_inverse(stream_u16: np.ndarray, meta: KVBlockMeta) -> np.ndarray:
    """Invert :func:`kv_forward` → token-major (n, C) uint16."""
    return kv_inverse_batch(stream_u16.reshape(1, -1), [meta])[0]


def kv_forward_batch(windows: np.ndarray) -> tuple[np.ndarray, list]:
    """Vectorized :func:`kv_forward` over same-shape ``(B, n, C)`` uint16
    windows → ``((B, n*C)`` transformed streams, ``B`` metas)``; the modal
    exponents come from one offset-bincount over all ``B*C`` channel
    groups."""
    B, n, C = windows.shape
    cm = np.ascontiguousarray(windows.transpose(0, 2, 1))   # (B, C, n)
    exp = ((cm & _EXP_MASK) >> EXP_LO).astype(np.uint8)
    offs = (np.arange(B * C, dtype=np.int64) * 256)[:, None]
    counts = np.bincount(
        (exp.reshape(B * C, n).astype(np.int64) + offs).ravel(),
        minlength=256 * B * C,
    ).reshape(B * C, 256)
    beta = counts.argmax(axis=1).astype(np.uint8).reshape(B, C)
    delta = (exp.astype(np.int16) - beta[:, :, None].astype(np.int16)) % 256
    z = _zigzag_u8(delta.astype(np.uint8))
    out = (cm & _REST_MASK) | (z.astype(np.uint16) << EXP_LO)
    metas = [KVBlockMeta(beta=beta[b].copy(), n_tokens=n, n_channels=C)
             for b in range(B)]
    return out.reshape(B, n * C), metas


def kv_inverse_batch(streams: np.ndarray, metas: list) -> np.ndarray:
    """Vectorized :func:`kv_inverse`: ``(B, n*C)`` uint16 streams with
    ``B`` same-shape metas → token-major ``(B, n, C)`` uint16."""
    C, n = metas[0].n_channels, metas[0].n_tokens
    cm = streams.reshape(len(metas), C, n)
    beta = np.stack([m.beta for m in metas])          # (B, C)
    z = ((cm & _EXP_MASK) >> EXP_LO).astype(np.uint8)
    delta = _unzigzag_u8(z)
    exp = (delta.astype(np.int16) + beta[:, :, None].astype(np.int16)) % 256
    out = (cm & _REST_MASK) | (exp.astype(np.uint16) << EXP_LO)
    return np.ascontiguousarray(out.transpose(0, 2, 1))
