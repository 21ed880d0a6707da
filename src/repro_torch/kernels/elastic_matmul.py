"""Elastic-precision dequant matmul: the Hopper kernel
(``csrc/elastic_matmul.cu``), its plain PyTorch version and the K-major
weight packing it reads.

Replaces ``src/repro/kernels/elastic_matmul.py::_kernel``.  A ``(K, N)``
bf16 weight is stored as K-packed bit-planes ``(16, K // 8, N)`` uint8
(:func:`pack_weights_kmajor`); a product at a precision view reads only
the view's fetched planes, the top ``P`` of the stack (so the bytes read
scale with the view), rebuilds each weight with the view's guard round
and multiplies in f32:

    out (M, N) f32 = x (M, K) bf16 @ reconstruct(planes)

The public entry point with the reference's ``(r_m, d_m)`` signature is
``kernels.ops.elastic_matmul``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.bitplane import BF16_BITS
from . import build
from .bitplane import (
    RoundParams, plane_code, to_int16, view_round_plain,
)


# Fewest planes the kernel reads: the sign and the 8 exponent planes.
MIN_PLANES = 9


def pack_weights_kmajor(w: torch.Tensor) -> torch.Tensor:
    """``(K, N)`` weight (any float type, rounded to bf16) → ``(16, K // 8,
    N)`` uint8 K-packed planes: byte ``(r, n)`` of plane ``p`` holds bit
    ``p`` of rows ``8r..8r+7`` of column ``n``, the first row in the MSB
    (``repro.kernels.ref.pack_weights_kmajor``)."""
    K, N = w.shape
    if K % 8:
        raise ValueError(f"K={K} is not a multiple of 8")
    u = w.to(torch.bfloat16).contiguous().view(torch.int16).to(torch.int32)
    shifts = torch.arange(BF16_BITS, dtype=torch.int32, device=w.device)
    bits = (u[None] >> shifts[:, None, None]) & 1               # (16, K, N)
    weights = 128 >> torch.arange(8, dtype=torch.int32, device=w.device)
    packed = (bits.view(BF16_BITS, K // 8, 8, N)
              * weights[None, None, :, None]).sum(2, dtype=torch.int32)
    return packed.to(torch.uint8)


def unpack_weights_plain(planes: torch.Tensor, plane_ids: Sequence[int],
                         rnd: RoundParams) -> torch.Tensor:
    """``(P_f, K // 8, N)`` fetched planes → ``(K, N)`` bf16 weight at the
    view (absent planes zero, then the guard round)."""
    P, K8, N = planes.shape
    shifts = 7 - torch.arange(8, dtype=torch.int32, device=planes.device)
    bits = (planes.to(torch.int32)[:, :, None, :]
            >> shifts[None, None, :, None]) & 1                # (P, K8, 8, N)
    pos = torch.tensor([int(p) for p in plane_ids], dtype=torch.int32,
                       device=planes.device)
    u = (bits << pos[:, None, None, None]).sum(0, dtype=torch.int32)
    u = view_round_plain(u.reshape(K8 * 8, N), rnd)
    return to_int16(u).view(torch.bfloat16)


def elastic_matmul_plain(x: torch.Tensor, planes: torch.Tensor,
                         plane_ids: Sequence[int],
                         rnd: RoundParams) -> torch.Tensor:
    """Plain version: unpack along K, round, then ``x.float() @ w.float()``
    (any device; on the card with TF32 off this is a full-f32 product)."""
    w = unpack_weights_plain(planes, plane_ids, rnd)
    return x.float() @ w.float()


def elastic_matmul_planes(x: torch.Tensor, planes: torch.Tensor,
                          plane_ids: Sequence[int],
                          rnd: RoundParams) -> torch.Tensor:
    """``x (M, K)`` bf16 times the weight rebuilt from its fetched
    ``(P_f, K // 8, N)`` planes at round ``rnd`` → ``(M, N)`` f32, on the
    tensors' device: the CUDA kernel on the card,
    :func:`elastic_matmul_plain` on the CPU.  The kernel takes the top
    ``P_f >= 9`` planes, in the order a view fetches them (15 first) or in
    the stack's own order (``w_planes[16 - P_f:]``, read in place)."""
    if x.dim() != 2 or planes.dim() != 3:
        raise ValueError(f"bad shapes x {tuple(x.shape)} planes "
                         f"{tuple(planes.shape)}")
    M, K = x.shape
    P, K8, N = planes.shape
    if K8 * 8 != K or P != len(plane_ids):
        raise ValueError(f"x {tuple(x.shape)} does not match planes "
                         f"{tuple(planes.shape)} of {len(plane_ids)} ids")
    if x.dtype != torch.bfloat16 or planes.dtype != torch.uint8:
        raise TypeError(f"expects bf16 x and uint8 planes, got {x.dtype}, "
                        f"{planes.dtype}")
    plane_code(plane_ids)                      # validates the ids
    if x.device.type == "cpu" and planes.device.type == "cpu":
        return elastic_matmul_plain(x, planes, plane_ids, rnd)
    if x.device.type != "cuda" or planes.device != x.device:
        raise ValueError(f"elastic matmul needs x and planes on one CUDA "
                         f"device, got {x.device}/{planes.device}")
    if not (x.is_contiguous() and planes.is_contiguous()):
        raise ValueError("elastic matmul kernel needs contiguous tensors")
    if x.data_ptr() % 16:
        raise ValueError("elastic matmul kernel needs a 16-byte aligned x")
    if P < MIN_PLANES:
        raise ValueError(f"the kernel needs at least {MIN_PLANES} planes "
                         f"(sign and exponent), got {P}")
    ids = [int(p) for p in plane_ids]
    top = list(range(BF16_BITS - 1, BF16_BITS - 1 - P, -1))
    plane_bytes = K8 * N
    if ids == top:                 # slot i is bit 15 - i
        base, stride = planes.data_ptr(), plane_bytes
    elif ids == top[::-1]:         # the stack's own order: read it backwards
        base, stride = planes.data_ptr() + (P - 1) * plane_bytes, -plane_bytes
    else:
        raise ValueError(f"the kernel reads the top {P} planes in either "
                         f"order, got {ids}")
    keep, cut, do_round = rnd
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = build.load("elastic_matmul").elastic_matmul(
        x.data_ptr(), base, stride, out.data_ptr(), M, K, N, P, keep, cut,
        int(do_round), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "elastic_matmul")
    build.LAUNCHES["elastic_matmul"] += 1
    return out
