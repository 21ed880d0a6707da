"""Bit-plane pack and unpack: the Hopper kernels
(``csrc/bitplane_pack.cu``, ``csrc/bitplane_unpack.cu``), their plain
PyTorch versions, the tier's slab entry points and the precision-view
round they share with ``kernels.kv_delta`` and ``kernels.elastic_matmul``.

Replaces ``src/repro/kernels/bitplane.py::_pack_kernel`` and
``::_unpack_kernel``.  Each wrapper launches its CUDA kernel for a tensor
on the card and takes the plain version for a tensor on the CPU.  Pack
produces the bytes of ``core.bitplane.pack_planes``; unpack the words of
``core.bitplane.unpack_planes_subset``, rounded as
``core.precision.reconstruct_u16`` rounds them when given a view.
:func:`unpack_kv_windows` is the tier's KV read: unpack, exponent-delta
inverse and round of a group of windows in one launch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.bitplane import BF16_BITS
from . import build

# (keep mask, cut, do_round) of a precision view, the constants of the
# shared ``csrc/view_round.cuh``.
RoundParams = Tuple[int, int, bool]
NO_ROUND: RoundParams = (0xFFFF, 1, False)


def pack_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pack: flat ``(n,)`` 16-bit → ``(16, n // 8)`` uint8.

    Bit math runs in int32 (PyTorch has no ``>>`` for uint16 on the CPU).
    """
    n = x.numel()
    v = x.view(torch.int16).to(torch.int32) & 0xFFFF
    shifts = torch.arange(BF16_BITS, dtype=torch.int32, device=x.device)
    bits = (v[None, :] >> shifts[:, None]) & 1
    weights = 128 >> torch.arange(8, dtype=torch.int32, device=x.device)
    packed = (bits.view(BF16_BITS, n // 8, 8) * weights).sum(
        -1, dtype=torch.int32)
    return packed.to(torch.uint8)


def pack_planes_u16(x: torch.Tensor) -> torch.Tensor:
    """Pack a flat ``(n,)`` uint16/int16 tensor (``n % 8 == 0``) to its
    ``(16, n // 8)`` uint8 plane stack, on the tensor's device."""
    if x.dtype not in (torch.int16, torch.uint16):
        raise TypeError(f"pack expects int16/uint16, got {x.dtype}")
    if x.dim() != 1 or x.numel() % 8:
        raise ValueError(f"pack expects a flat slab of 8k elements, got "
                         f"shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pack_planes_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("pack kernel needs a contiguous, 16-byte aligned slab")
    n = x.numel()
    out = torch.empty((BF16_BITS, n // 8), dtype=torch.uint8, device=x.device)
    rc = build.load("bitplane_pack").pack_planes_u16(
        x.data_ptr(), out.data_ptr(), n, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "bitplane_pack")
    build.LAUNCHES["bitplane_pack"] += 1
    return out


def pack_planes_slab(flat_u16, device: torch.device) -> torch.Tensor:
    """Pack a flat uint16 encode slab (numpy or tensor) to ``(16, n // 8)``
    uint8 planes on ``device`` — the write-side pack of the batched encode
    pipeline.  The planes stay on ``device`` for the LZ4 match kernel."""
    if isinstance(flat_u16, np.ndarray):
        flat = np.ascontiguousarray(flat_u16, dtype=np.uint16).ravel()
        if flat.size % 8:
            raise ValueError(f"slab length {flat.size} not a multiple of 8")
        if not flat.flags.writeable:
            flat = flat.copy()
        x = torch.from_numpy(flat.view(np.int16)).to(device)
    else:
        x = flat_u16.reshape(-1).to(device)
    return pack_planes_u16(x)


# ---------------------------------------------------------------------------
# precision-view round (the tail of _unpack_kernel, csrc/view_round.cuh)
# ---------------------------------------------------------------------------

def round_params(r_e: int = 8, r_m: int = 7, d_m: int = 0) -> RoundParams:
    """The view's kept-bit mask, mantissa cut and whether guard planes
    round: RNE only with guard planes (``d_m > 0``), all 8 exponent
    planes and a cut (``r_m < 7``), as ``reconstruct_u16`` rounds."""
    keep = (0x8000 | (((1 << r_e) - 1) << (15 - r_e))
            | (((1 << r_m) - 1) << (7 - r_m)))
    cut = 7 - r_m
    return keep, max(cut, 1), bool(d_m > 0 and r_e == 8 and cut > 0)


def view_round_params(view) -> RoundParams:
    """:func:`round_params` of a ``PrecisionView`` (``None``: no round)."""
    if view is None:
        return NO_ROUND
    return round_params(view.r_e, view.r_m, view.d_m)


def view_round_plain(u: torch.Tensor, rnd: RoundParams) -> torch.Tensor:
    """Plain version of ``view_round``: int32 bf16 patterns → rounded and
    masked int32 patterns."""
    keep, cut, do_round = rnd
    if do_round:
        mag = u & 0x7FFF
        special = (u & 0x7F80) == 0x7F80
        half, gmask = 1 << (cut - 1), (1 << cut) - 1
        guard = mag & gmask
        lsb = (mag >> cut) & 1
        up = (guard > half) | ((guard == half) & (lsb == 1))
        mag = ((mag & ~gmask) + (up.to(torch.int32) << cut)).clamp_max(0x7F80)
        kept = u & keep
        nan_lost = special & ((u & 0x7F) != 0) & ((kept & 0x7F) == 0)
        kept = torch.where(nan_lost, kept | 0x40, kept)
        u = torch.where(special, kept, (u & 0x8000) | mag)
    return u & keep


def to_int16(u: torch.Tensor) -> torch.Tensor:
    """int32 patterns in [0, 65536) → the int16 tensor of the same bits."""
    return torch.where(u >= 0x8000, u - 0x10000, u).to(torch.int16)


# ---------------------------------------------------------------------------
# unpack: fetched plane rows → words (csrc/bitplane_unpack.cu)
# ---------------------------------------------------------------------------

def plane_code(plane_ids: Sequence[int]) -> int:
    """Plane ids packed four bits each (plane ``plane_ids[i]`` in bits
    ``4i..4i+3``), as the kernels take them."""
    if len(plane_ids) > BF16_BITS:
        raise ValueError(f"at most {BF16_BITS} planes, got {len(plane_ids)}")
    if len(set(int(p) for p in plane_ids)) != len(plane_ids):
        raise ValueError(f"repeated plane id in {list(plane_ids)}")
    code = 0
    for i, p in enumerate(plane_ids):
        if not 0 <= int(p) < BF16_BITS:
            raise ValueError(f"plane id {p} outside [0, {BF16_BITS})")
        code |= int(p) << (4 * i)
    return code


def unpack_planes_plain(rows: torch.Tensor, plane_ids: Sequence[int],
                        rnd: RoundParams = NO_ROUND) -> torch.Tensor:
    """Plain PyTorch unpack: ``(P_f, nbytes)`` uint8 rows, row ``i`` the
    stream of plane ``plane_ids[i]`` → ``(8 * nbytes,)`` int16 words
    (absent planes zero), rounded with ``rnd``."""
    P, nbytes = rows.shape
    shifts = 7 - torch.arange(8, dtype=torch.int32, device=rows.device)
    bits = (rows.to(torch.int32)[:, :, None] >> shifts) & 1   # (P, nb, 8)
    pos = torch.tensor([int(p) for p in plane_ids], dtype=torch.int32,
                       device=rows.device)
    u = (bits << pos[:, None, None]).sum(0, dtype=torch.int32).reshape(-1)
    return to_int16(view_round_plain(u, rnd))


def unpack_planes(rows: torch.Tensor, plane_ids: Sequence[int],
                  view=None) -> torch.Tensor:
    """Unpack fetched plane rows to ``(8 * nbytes,)`` int16 words on the
    rows' device, rounded to ``view`` (a ``PrecisionView``; ``None`` keeps
    every fetched bit)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError(f"unpack expects (P_f, nbytes) uint8 rows, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.shape[0] != len(plane_ids):
        raise ValueError(f"{rows.shape[0]} rows for {len(plane_ids)} planes")
    code = plane_code(plane_ids)
    rnd = view_round_params(view)
    if rows.device.type == "cpu":
        return unpack_planes_plain(rows, plane_ids, rnd)
    _check_kernel_rows(rows)
    nbytes = rows.shape[1]
    out = torch.empty((8 * nbytes,), dtype=torch.int16, device=rows.device)
    rc = build.load("bitplane_unpack").unpack_planes_u16(
        rows.data_ptr(), out.data_ptr(), nbytes, rows.shape[0], code,
        rnd[0], rnd[1], int(rnd[2]), rows.device.index,
        torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(rc, "bitplane_unpack")
    build.LAUNCHES["bitplane_unpack"] += 1
    return out


def _check_kernel_rows(rows: torch.Tensor) -> None:
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("unpack kernels need contiguous rows")
    if rows.shape[0] == 0:
        raise ValueError("unpack kernels take 1 to 16 planes, got none")


# ---------------------------------------------------------------------------
# fused KV read: unpack → exponent-delta inverse → round, one launch per
# group of same-shape windows (csrc/bitplane_unpack.cu + csrc/kv_read.cuh)
# ---------------------------------------------------------------------------

# Windows one fused launch takes (kMaxWindows in csrc/bitplane_unpack.cu):
# a 64 Ki-element readback slab holds more only of windows under 256
# elements.
KV_READ_WINDOWS = 256

def unpack_kv_windows_plain(rows: torch.Tensor, plane_ids: Sequence[int],
                            starts: Sequence[int], n: int, C: int,
                            beta: torch.Tensor, view=None) -> torch.Tensor:
    """Plain version of the fused KV read: :func:`unpack_planes_plain` of
    each window's bytes, then ``kv_delta.kv_inverse_plain``."""
    from .kv_delta import kv_inverse_plain

    B, L = len(starts), n * C
    nb = -(-L // 8)
    first = torch.tensor([s // 8 for s in starts], dtype=torch.int64,
                         device=rows.device)
    cols = (first[:, None] + torch.arange(nb, device=rows.device)).reshape(-1)
    raw = unpack_planes_plain(rows[:, cols], plane_ids).view(B, 8 * nb)
    return kv_inverse_plain(raw[:, :L].reshape(B, C, n), beta, view)


def unpack_kv_windows(rows: torch.Tensor, plane_ids: Sequence[int],
                      starts: Sequence[int], n: int, C: int,
                      beta: torch.Tensor, view=None) -> torch.Tensor:
    """The KV windows of one ``(n, C)`` group of a readback slab →
    ``(B, n, C)`` int16 token-major words on the rows' device: window
    ``b``'s channel-major stream starts at element ``starts[b]`` (a
    multiple of 8) of the fetched ``rows``; its exponent deltas are
    inverted with ``beta`` ``(B, C)`` uint8 and the words rounded to
    ``view`` after the inverse.  On the card one launch, counted under
    ``bitplane_unpack`` (one per :data:`KV_READ_WINDOWS` windows); what
    ``kv_inverse(unpack_planes(...))`` gives.  The starts travel in the
    launch's parameters."""
    from .kv_delta import check_beta

    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError(f"unpack expects (P_f, nbytes) uint8 rows, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.shape[0] != len(plane_ids):
        raise ValueError(f"{rows.shape[0]} rows for {len(plane_ids)} planes")
    code = plane_code(plane_ids)
    starts = [int(s) for s in starts]
    B, nbytes = len(starts), rows.shape[1]
    for s in starts:
        if s % 8 or s < 0 or s + n * C > 8 * nbytes:
            raise ValueError(f"window start {s} of {n} x {C} elements is "
                             f"not a byte inside {nbytes}-byte rows")
    check_beta(beta, B, C, rows.device)
    if rows.device.type == "cpu":
        return unpack_kv_windows_plain(rows, plane_ids, starts, n, C, beta,
                                       view)
    _check_kernel_rows(rows)
    if not beta.is_contiguous():
        raise ValueError("the KV read kernel needs a contiguous beta")
    keep, cut, do_round = view_round_params(view)
    out = torch.empty((B, n, C), dtype=torch.int16, device=rows.device)
    lib = build.load("bitplane_unpack")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    for b0 in range(0, B, KV_READ_WINDOWS):
        part = torch.tensor(starts[b0 : b0 + KV_READ_WINDOWS],
                            dtype=torch.int64)
        rc = lib.unpack_kv_windows(
            rows.data_ptr(), nbytes, rows.shape[0], code, part.data_ptr(),
            beta[b0].data_ptr(), out[b0].data_ptr(), part.numel(), n, C,
            keep, cut, int(do_round), rows.device.index, stream)
        build.check(rc, "bitplane_unpack")
        build.LAUNCHES["bitplane_unpack"] += 1
    return out
