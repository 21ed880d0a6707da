"""Bit-plane pack: the Hopper kernel (``csrc/bitplane_pack.cu``), its
plain PyTorch version, and the tier's slab entry point.

Replaces ``src/repro/kernels/bitplane.py::_pack_kernel``.  The wrapper
launches the CUDA kernel for a tensor on the card and takes the plain
version for a tensor on the CPU; both produce the bytes of
``core.bitplane.pack_planes``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitplane import BF16_BITS
from . import build


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
