"""Elastic precision access — plane selection, guard rounding, reconstruction.

Paper §III-C.  A *precision view* of a BF16 tensor is defined by the number
of exponent/mantissa planes retained ``(r_e, r_m)`` plus guard planes
``(d_e, d_m)`` used for on-device round-to-nearest.  The controller always
fetches the sign plane and the MOST significant ``r_e + d_e`` exponent and
``r_m + d_m`` mantissa planes (Eq. 6); it never inspects element values.

Reconstruction (the ``R`` operator of Eq. 7): guard bits drive
round-to-nearest-even at the mantissa cut (the carry may propagate into
the exponent); dropped planes read as zero; Inf/NaN patterns are kept.

KV blocks that went through the cross-token transform hold zigzagged
exponent deltas, so KV views always fetch all 8 exponent planes and scale
only mantissa planes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .bitplane import (
    EXP_BITS,
    EXP_HI,
    MAN_BITS,
    MAN_HI,
    SIGN_BIT,
    plane_bytes,
    unpack_planes,
)


@dataclasses.dataclass(frozen=True)
class PrecisionView:
    """A reduced-precision alias of a BF16 tensor (paper Fig. 9).

    ``r_e``/``r_m``: exponent / mantissa planes returned to the host.
    ``d_e``/``d_m``: guard planes fetched beyond the cut for rounding.
    """

    r_e: int = EXP_BITS
    r_m: int = MAN_BITS
    d_e: int = 0
    d_m: int = 0
    name: str = ""

    def __post_init__(self):
        if not (0 <= self.r_e <= EXP_BITS):
            raise ValueError(f"r_e={self.r_e} out of range")
        if not (0 <= self.r_m <= MAN_BITS):
            raise ValueError(f"r_m={self.r_m} out of range")
        if self.r_e + self.d_e > EXP_BITS or self.r_m + self.d_m > MAN_BITS:
            raise ValueError("guard planes exceed field width")

    @property
    def bits(self) -> int:
        """Host-visible effective bits (1 + r_e + r_m)."""
        return 1 + self.r_e + self.r_m

    def kept_planes(self) -> Tuple[int, ...]:
        """Planes whose bits survive into the host-visible value (Eq. 6)."""
        exp = tuple(range(EXP_HI, EXP_HI - self.r_e, -1))
        man = tuple(range(MAN_HI, MAN_HI - self.r_m, -1))
        return (SIGN_BIT,) + exp + man

    def fetched_planes(self) -> Tuple[int, ...]:
        """Planes physically read from DRAM (kept + guard)."""
        exp = tuple(range(EXP_HI, EXP_HI - self.r_e - self.d_e, -1))
        man = tuple(range(MAN_HI, MAN_HI - self.r_m - self.d_m, -1))
        return (SIGN_BIT,) + exp + man

    def plane_mask(self) -> int:
        """Bitmask over plane indices (bit i set = plane i fetched)."""
        m = 0
        for p in self.fetched_planes():
            m |= 1 << p
        return m

    @property
    def is_full(self) -> bool:
        return self.r_e == EXP_BITS and self.r_m == MAN_BITS


FULL = PrecisionView(name="bf16")                                  # 16 bits
MAN4 = PrecisionView(r_m=4, d_m=1, name="man4")                    # 13 bits
MAN2 = PrecisionView(r_m=2, d_m=1, name="man2")                    # 11 bits
MAN0 = PrecisionView(r_m=0, d_m=1, name="man0")                    # 9 bits
VIEWS = {v.name: v for v in (FULL, MAN4, MAN2, MAN0)}

# PNM scoring view: sign + the full exponent, no mantissa planes and no
# guard.  A ranking alias, not a storage precision, so not in VIEWS.
SCORE = PrecisionView(r_m=0, d_m=0, name="score")                  # 9 bits


_EXP_ALL_ONES = np.uint16(((1 << EXP_BITS) - 1) << (MAN_HI + 1))


def _field_keep_mask(view: PrecisionView) -> int:
    """uint16 mask of bits kept in the host-visible value."""
    m = 1 << SIGN_BIT
    for p in view.kept_planes():
        m |= 1 << p
    return m


def reconstruct_u16(fetched_u16: np.ndarray, view: PrecisionView) -> np.ndarray:
    """Apply guard-plane round-to-nearest-even + zero padding.

    ``fetched_u16`` holds the bit patterns assembled from the *fetched*
    planes (missing planes already zero).  Returns host-visible uint16
    patterns containing only kept planes.
    """
    x = fetched_u16.astype(np.uint16)
    if view.is_full:
        return x

    keep = np.uint16(_field_keep_mask(view))
    cut = MAN_HI - view.r_m + 1

    if view.d_m == 0 or view.r_e != EXP_BITS:
        return x & keep

    sign = x & np.uint16(1 << SIGN_BIT)
    mag = x & np.uint16((1 << SIGN_BIT) - 1)
    is_special = (x & _EXP_ALL_ONES) == _EXP_ALL_ONES  # Inf/NaN: keep as-is

    half = np.uint16(1 << (cut - 1))
    guard_mask = np.uint16((1 << cut) - 1)
    guard = mag & guard_mask
    lsb = (mag >> np.uint16(cut)) & np.uint16(1)
    round_up = (guard > half) | ((guard == half) & (lsb == 1))
    mag_r = (mag & ~guard_mask) + (round_up.astype(np.uint16) << np.uint16(cut))
    # Carry into exponent is the correct FP rounding; saturate at Inf pattern.
    mag_r = np.minimum(mag_r, _EXP_ALL_ONES)

    # A NaN whose payload lives only in dropped planes must stay NaN.
    special_out = x & keep
    if view.r_m > 0:
        man_mask = np.uint16(((1 << MAN_BITS) - 1))
        nan_lost = is_special & ((x & man_mask) != 0) & ((special_out & man_mask) == 0)
        special_out = np.where(
            nan_lost, special_out | np.uint16(1 << MAN_HI), special_out
        )
    out = np.where(is_special, special_out, sign | mag_r)
    return (out & keep).astype(np.uint16)


def assemble_from_planes(planes: np.ndarray, n_elems: int,
                         view: PrecisionView) -> np.ndarray:
    """Words of a full ``(16, m // 8)`` plane stack at ``view``: the
    view's fetched planes unpacked (the rest read as zero), then
    reconstructed."""
    sel = np.zeros_like(planes)
    for p in view.fetched_planes():
        sel[p] = planes[p]
    return reconstruct_u16(unpack_planes(sel, n_elems), view)


def truncate_reference(u16: np.ndarray, view: PrecisionView) -> np.ndarray:
    """Oracle: mask to the fetched planes, then apply guard rounding."""
    fetch_mask = np.uint16(0)
    for p in view.fetched_planes():
        fetch_mask |= np.uint16(1 << p)
    return reconstruct_u16(u16 & fetch_mask, view)


def view_dram_bytes(n_elems: int, view: PrecisionView) -> int:
    """Uncompressed DRAM bytes touched to serve this view (plane-aligned)."""
    return len(view.fetched_planes()) * plane_bytes(n_elems)
