"""Bit-plane disaggregation — the physical substrate of TRACE (paper §III-A).

A block of ``m`` values, each ``B`` bits wide, is stored as the *transpose*
of its logical bit-matrix: ``B`` bit-planes, each a packed bitstream of
``m`` bits.  Plane ``i`` collects bit position ``i`` (0 = LSB) of every
element.  The transform is a pure permutation of bits, hence exactly
lossless for any payload including NaN/Inf/subnormals.

These are the numpy forms the tier's host side uses (the read path's
subset unpack, the scalar reference encoder).  The write path's pack runs
as a kernel on the card (``kernels.bitplane``), byte-identical to
:func:`pack_planes`.

BF16 field layout (bit position, 0 = LSB):
    sign      = bit 15
    exponent  = bits 14..7   (8 bits)
    mantissa  = bits 6..0    (7 bits)
"""

from __future__ import annotations

import numpy as np

BF16_BITS = 16
SIGN_BIT = 15
EXP_HI, EXP_LO = 14, 7          # inclusive bit range of the exponent field
MAN_HI, MAN_LO = 6, 0           # inclusive bit range of the mantissa field
EXP_BITS = EXP_HI - EXP_LO + 1  # 8
MAN_BITS = MAN_HI - MAN_LO + 1  # 7

# Default device block: 2048 BF16 elements = 4 KiB, aligned to DRAM rows.
BLOCK_ELEMS = 2048


def pack_planes(u16: np.ndarray, bits: int = BF16_BITS) -> np.ndarray:
    """Disaggregate ``u16`` (flat uint16, length multiple of 8) into packed
    bit-planes: ``(bits, len(u16) // 8)`` uint8, ``planes[i]`` the stream
    of bit ``i`` across all elements, MSB-first within each byte."""
    u16 = np.ascontiguousarray(u16, dtype=np.uint16).ravel()
    if u16.size % 8:
        raise ValueError(f"block length {u16.size} not a multiple of 8")
    shifts = np.arange(bits, dtype=np.uint16)[:, None]
    bitmat = (u16[None, :] >> shifts) & np.uint16(1)
    return np.packbits(bitmat.astype(np.uint8), axis=1)


def unpack_planes(planes: np.ndarray, n_elems: int, bits: int = BF16_BITS) -> np.ndarray:
    """Inverse of :func:`pack_planes` → flat uint16 of length ``n_elems``."""
    bitmat = np.unpackbits(planes, axis=1, count=n_elems).astype(np.uint16)
    shifts = np.arange(bits, dtype=np.uint16)[:, None]
    return np.bitwise_or.reduce(bitmat << shifts, axis=0)


def plane_bytes(n_elems: int) -> int:
    """Bytes per plane for a block of ``n_elems`` elements."""
    return (n_elems + 7) // 8


def unpack_planes_subset(rows: np.ndarray, plane_idx, n_elems: int) -> np.ndarray:
    """Unpack only the planes in ``plane_idx`` (absent planes read as zero).

    ``rows`` is a ``(len(plane_idx), nbytes) uint8`` matrix whose i-th row
    is the packed stream of plane ``plane_idx[i]``; accumulates plane by
    plane so temporaries stay one-plane-sized.
    """
    out = np.zeros(n_elems, dtype=np.uint16)
    for i, p in enumerate(plane_idx):
        bits = np.unpackbits(rows[i], count=n_elems)
        out |= bits.astype(np.uint16) << np.uint16(p)
    return out


def iter_blocks(u16: np.ndarray, block_elems: int = BLOCK_ELEMS):
    """Yield fixed-size blocks of a flat uint16 tensor, zero-padding the
    tail, as ``(block, valid)`` with ``valid`` the real element count."""
    u16 = u16.ravel()
    n = u16.size
    for start in range(0, n, block_elems):
        chunk = u16[start : start + block_elems]
        valid = chunk.size
        if valid < block_elems:
            chunk = np.pad(chunk, (0, block_elems - valid))
        yield chunk, valid
