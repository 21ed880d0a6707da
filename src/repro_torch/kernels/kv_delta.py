"""Cross-token KV exponent-delta transform: the Hopper kernels
(``csrc/kv_delta.cu``) and their plain PyTorch versions.

Replaces ``src/repro/kernels/kv_delta.py::_fwd_kernel`` and
``::_inv_kernel``.  Over a batch of ``B`` same-shape windows:

* :func:`kv_forward` — ``(B, n, C)`` token-major bf16 patterns →
  ``(B, C, n)`` channel-major, each exponent replaced by
  ``zigzag((exp - beta) mod 256)``, plus ``beta (B, C)`` uint8: the modal
  exponent of each channel with ties to the smallest, as
  ``core.kv_transform.kv_forward_batch`` computes it (or a given beta);
* :func:`kv_inverse` — the exact inverse for any beta, then the
  precision view's guard round on the token-major words (after the
  inverse: a round's carry may move into the exponent, and Inf/NaN are
  recognisable only in the real-exponent domain).  The kernel API's
  inverse; the tier's KV read runs the same stage fused with the unpack
  (``kernels.bitplane.unpack_kv_windows``).

Bit patterns are int16 (or uint16) tensors; bit math runs in int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .bitplane import view_round_params, view_round_plain, to_int16

_BITS = (torch.int16, torch.uint16)


def modal_beta_plain(windows: torch.Tensor) -> torch.Tensor:
    """``(B, n, C)`` patterns → ``(B, C)`` uint8 modal exponents, ties to
    the smallest exponent (``np.bincount(...).argmax()``)."""
    B, n, C = windows.shape
    exp = (windows.to(torch.int32) >> 7) & 0xFF                 # (B, n, C)
    counts = torch.zeros((B, C, 256), dtype=torch.int32,
                         device=windows.device)
    counts.scatter_add_(2, exp.transpose(1, 2).to(torch.int64),
                        torch.ones_like(exp).transpose(1, 2))
    top = counts.amax(dim=2, keepdim=True)
    bins = torch.arange(256, dtype=torch.int32, device=windows.device)
    return torch.where(counts == top, bins, 256).amin(dim=2).to(torch.uint8)


def kv_forward_plain(windows: torch.Tensor,
                     beta: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``(B, n, C)`` → (``(B, C, n)`` int16, ``(B, C)``
    uint8 beta); beta is the modal exponent unless given."""
    if beta is None:
        beta = modal_beta_plain(windows)
    cm = windows.to(torch.int32).transpose(1, 2) & 0xFFFF       # (B, C, n)
    d = (((cm >> 7) & 0xFF) - beta.to(torch.int32)[:, :, None]) & 0xFF
    z = torch.where(d < 128, 2 * d, 511 - 2 * d)
    return to_int16((cm & 0x807F) | (z << 7)).contiguous(), beta


def kv_inverse_plain(cm: torch.Tensor, beta: torch.Tensor,
                     view=None) -> torch.Tensor:
    """Plain inverse: ``(B, C, n)`` + ``(B, C)`` beta → ``(B, n, C)``
    int16, rounded to ``view`` (``None``: exact)."""
    v = cm.to(torch.int32) & 0xFFFF
    z = (v >> 7) & 0xFF
    s = torch.where(z % 2 == 0, z // 2, -((z + 1) // 2))
    exp = (s + beta.to(torch.int32)[:, :, None]) & 0xFF
    out = ((v & 0x807F) | (exp << 7)).transpose(1, 2)
    return to_int16(view_round_plain(out, view_round_params(view))).contiguous()


def check_beta(beta: torch.Tensor, B: int, C: int, dev: torch.device):
    if beta.shape != (B, C) or beta.dtype != torch.uint8:
        raise ValueError(f"beta must be ({B}, {C}) uint8, got "
                         f"{beta.dtype} {tuple(beta.shape)}")
    if beta.device != dev:
        raise ValueError(f"beta on {beta.device}, windows on {dev}")


def kv_forward(windows: torch.Tensor, beta: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward transform on the windows' device: the CUDA kernel on the
    card (which also finds the modal beta when none is given),
    :func:`kv_forward_plain` on the CPU."""
    if windows.dim() != 3 or windows.dtype not in _BITS:
        raise TypeError(f"kv_forward expects (B, n, C) int16/uint16, got "
                        f"{windows.dtype} {tuple(windows.shape)}")
    B, n, C = windows.shape
    if beta is not None:
        check_beta(beta, B, C, windows.device)
    if windows.device.type == "cpu":
        return kv_forward_plain(windows, beta)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    if not windows.is_contiguous() or (beta is not None
                                       and not beta.is_contiguous()):
        raise ValueError("kv_forward kernel needs contiguous tensors")
    out = torch.empty((B, C, n), dtype=torch.int16, device=windows.device)
    find = beta is None
    if find:
        beta = torch.empty((B, C), dtype=torch.uint8, device=windows.device)
    rc = build.load("kv_delta").kv_delta_fwd(
        windows.data_ptr(), out.data_ptr(), beta.data_ptr(), B, n, C,
        int(find), windows.device.index,
        torch.cuda.current_stream(windows.device).cuda_stream)
    build.check(rc, "kv_delta_fwd")
    build.LAUNCHES["kv_delta_fwd"] += 1
    return out, beta


def kv_inverse(cm: torch.Tensor, beta: torch.Tensor,
               view=None) -> torch.Tensor:
    """Inverse transform (+ the view's round) on the tensors' device: the
    CUDA kernel on the card, :func:`kv_inverse_plain` on the CPU."""
    if cm.dim() != 3 or cm.dtype not in _BITS:
        raise TypeError(f"kv_inverse expects (B, C, n) int16/uint16, got "
                        f"{cm.dtype} {tuple(cm.shape)}")
    B, C, n = cm.shape
    check_beta(beta, B, C, cm.device)
    if cm.device.type == "cpu":
        return kv_inverse_plain(cm, beta, view)
    if cm.device.type != "cuda":
        raise ValueError(f"unsupported device {cm.device}")
    if not (cm.is_contiguous() and beta.is_contiguous()):
        raise ValueError("kv_inverse kernel needs contiguous tensors")
    keep, cut, do_round = view_round_params(view)
    out = torch.empty((B, n, C), dtype=torch.int16, device=cm.device)
    rc = build.load("kv_delta").kv_delta_inv(
        cm.data_ptr(), beta.data_ptr(), out.data_ptr(), B, n, C, keep, cut,
        int(do_round), cm.device.index,
        torch.cuda.current_stream(cm.device).cuda_stream)
    build.check(rc, "kv_delta_inv")
    build.LAUNCHES["kv_delta_inv"] += 1
    return out
