"""The kernel API: PyTorch twins of the public wrappers of
``src/repro/kernels/ops.py``, each a thin function over the kernel
modules.  Every function runs on its tensors' device (the CUDA kernel on
the card, the plain version on the CPU) and has no ``interpret`` flag.

Bit patterns are int16 tensors holding the reference's uint16 bits
(uint16 tensors are accepted too).
"""

from __future__ import annotations

from typing import List

import torch

from ..core.bitplane import BF16_BITS, MAN_HI, SIGN_BIT
from ..core.precision import PrecisionView
from . import bitplane as kbitplane
from . import decode_attn as kattn
from . import elastic_matmul as kmatmul
from . import kv_delta as kkv


def fetch_planes(r_e: int = 8, r_m: int = 7, d_m: int = 0) -> List[int]:
    """Planes a view reads: the sign, the top ``r_e`` exponent planes and
    the top ``r_m + d_m`` mantissa planes (guards included)."""
    return ([SIGN_BIT] + list(range(14, 14 - r_e, -1))
            + list(range(MAN_HI, MAN_HI - min(r_m + d_m, 7), -1)))


def _view(r_e: int, r_m: int, d_m: int) -> PrecisionView:
    return PrecisionView(r_e=r_e, r_m=r_m, d_m=min(d_m, 7 - r_m))


def bitplane_pack(x_u16: torch.Tensor) -> torch.Tensor:
    """``(R, C)`` bf16 patterns → ``(16, R, C // 8)`` uint8 plane stack."""
    R, C = x_u16.shape
    if C % 8:
        raise ValueError(f"C={C} is not a multiple of 8")
    planes = kbitplane.pack_planes_u16(x_u16.contiguous().reshape(-1))
    return planes.reshape(BF16_BITS, R, C // 8)


def elastic_unpack(planes: torch.Tensor, r_e: int = 8, r_m: int = 7,
                   d_m: int = 0) -> torch.Tensor:
    """Full ``(16, R, C // 8)`` plane stack → ``(R, C)`` int16 at the view
    ``(r_e, r_m, d_m)``.  Only the fetched planes are read (the others
    count as zero, as the reference zeroes them), then unpack and round
    run in one launch."""
    P, R, C8 = planes.shape
    if P != BF16_BITS:
        raise ValueError(f"expects a {BF16_BITS}-plane stack, got {P}")
    fetch = fetch_planes(r_e, r_m, d_m)
    rows = planes[fetch].reshape(len(fetch), R * C8)
    return kbitplane.unpack_planes(rows, fetch, _view(r_e, r_m, d_m)
                                   ).reshape(R, C8 * 8)


def kv_transform(block_u16: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Token-major ``(n, C)`` → channel-major exponent-delta ``(C, n)``
    against the given ``(C,)`` beta."""
    out, _ = kkv.kv_forward(block_u16.contiguous()[None],
                            beta.to(torch.uint8).contiguous()[None])
    return out[0]


def kv_transform_inv(cm_u16: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`kv_transform`: ``(C, n)`` → ``(n, C)``."""
    return kkv.kv_inverse(cm_u16.contiguous()[None],
                          beta.to(torch.uint8).contiguous()[None])[0]


def elastic_matmul(x: torch.Tensor, w_planes: torch.Tensor, r_m: int = 7,
                   d_m: int = 0) -> torch.Tensor:
    """``x (M, K)`` bf16 @ the weight rebuilt from its ``(16, K // 8, N)``
    K-packed planes at view ``(8, r_m, d_m)`` → ``(M, N)`` f32.  Only the
    fetched planes go to the kernel, so weight bytes scale as
    ``(9 + r_m + d_m) / 16``.  They are the top planes of the stack, a
    contiguous slice the kernel reads in place: nothing is copied."""
    if w_planes.dim() != 3 or w_planes.shape[0] != BF16_BITS:
        raise ValueError(f"expects (16, K // 8, N) planes, got "
                         f"{tuple(w_planes.shape)}")
    first = BF16_BITS - len(fetch_planes(8, r_m, d_m))
    return kmatmul.elastic_matmul_planes(
        x.contiguous(), w_planes[first:].contiguous(),
        list(range(first, BF16_BITS)), kbitplane.round_params(8, r_m, d_m))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """One-token GQA attention over a bf16 or fp8 cache → ``(B, H, hd)``
    f32 (``kernels.decode_attn``)."""
    return kattn.decode_attention(q, k, v, valid_len)
