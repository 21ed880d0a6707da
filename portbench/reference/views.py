"""Precision views of BF16 words, as the TRACE paper defines them (§III-C,
Eq. 6-7), written out plainly for the benchmark's reference.

A view keeps the sign, all 8 exponent bits and the top ``r_m`` of the 7
mantissa bits of each BF16 word, and reads ``d_m`` guard bits below the
cut.  With a guard bit the kept value is rounded to nearest, ties to even,
from the fetched bits alone (the bits below the guard were never fetched,
so a set guard bit is a tie); the carry may run into the exponent and
saturates at the infinity pattern.  Inf and NaN keep their pattern, and a
NaN whose payload only the dropped bits held stays a NaN.
"""

from __future__ import annotations

import torch

# name -> (r_m, d_m): kept mantissa bits and guard bits
VIEWS = {"bf16": (7, 0), "man4": (4, 1), "man2": (2, 1), "man0": (0, 1)}

_SIGN = 0x8000
_EXP = 0x7F80
_MAN = 0x007F


def _masks(r_m: int, d_m: int):
    keep = _SIGN | _EXP | (_MAN & ~((1 << (7 - r_m)) - 1))
    fetch = _SIGN | _EXP | (_MAN & ~((1 << max(7 - r_m - d_m, 0)) - 1))
    return keep, fetch


def view_words(words: torch.Tensor, name: str) -> torch.Tensor:
    """``words``: BF16 bit patterns as an integer tensor (any int dtype
    holding 0..65535, or int16 bit patterns) → the view's patterns as
    int32 values in 0..65535."""
    r_m, d_m = VIEWS[name]
    w = words.to(torch.int32) & 0xFFFF
    if r_m == 7:
        return w
    keep, fetch = _masks(r_m, d_m)
    x = w & fetch
    if d_m == 0:
        return x & keep
    cut = 7 - r_m
    sign = x & _SIGN
    mag = x & 0x7FFF
    special = (x & _EXP) == _EXP
    half = 1 << (cut - 1)
    gmask = (1 << cut) - 1
    guard = mag & gmask
    lsb = (mag >> cut) & 1
    up = (guard > half) | ((guard == half) & (lsb == 1))
    mag_r = torch.clamp((mag & ~gmask) + (up.to(torch.int32) << cut),
                        max=_EXP)
    special_out = x & keep
    if r_m > 0:
        lost = special & ((x & _MAN) != 0) & ((special_out & _MAN) == 0)
        special_out = torch.where(lost, special_out | (1 << 6), special_out)
    return torch.where(special, special_out, sign | mag_r) & keep


def bf16_words(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to BF16, as bit patterns in int32 (0..65535)."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def words_to_f32(words: torch.Tensor) -> torch.Tensor:
    """BF16 bit patterns (0..65535) → their float32 values."""
    w = words.to(torch.int32)
    w = torch.where(w >= 0x8000, w - 0x10000, w).to(torch.int16)
    return w.view(torch.bfloat16).float()


def view_values(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` stored as BF16 and read back at the view, as float32."""
    return words_to_f32(view_words(bf16_words(x), name))
