"""One-token GQA decode attention: the Hopper kernel
(``csrc/decode_attn.cu``) and its plain PyTorch version.

Replaces ``src/repro/kernels/decode_attn.py::_kernel``.  Shapes:

    q: (B, H, hd) bf16            — current token's queries
    k, v: (B, S, KV, hd) bf16 or float8_e4m3fn cache
    valid_len: int                — cache slots < valid_len attend
    out: (B, H, hd) f32

Query head ``h`` reads KV head ``h // (H // KV)``; slots at or past
``valid_len`` get a finite -1e30 score.  ``scale`` defaults to
``1 / sqrt(hd)``; the model's decode step passes queries already scaled
(``scale=1``), as the reference decode step's attention computes them.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

MAX_GROUP = 16          # query heads per KV head the kernel carries
HEAD_DIMS = (32, 64, 128)
_MASKED = -1e30


def _default_scale(hd: int) -> float:
    return 1.0 / (hd ** 0.5)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch decode attention in f32 (any device)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    scale = _default_scale(hd) if scale is None else scale
    qf = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos < valid_len, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return out.reshape(B, H, hd)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention on the tensors' device: the CUDA kernel on the
    card, :func:`decode_attention_plain` on the CPU."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, hd = q.shape
    Bk, S, KV, hdk = k.shape
    if Bk != B or hdk != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k.shape)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be bfloat16, got {q.dtype}")
    if k.dtype not in (torch.bfloat16, torch.float8_e4m3fn) or v.dtype != k.dtype:
        raise TypeError(f"cache must be bfloat16 or float8_e4m3fn, got "
                        f"{k.dtype}/{v.dtype}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid_len, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"decode attention needs q, k, v on one CUDA "
                         f"device, got {q.device}/{k.device}/{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode attention kernel needs contiguous tensors")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"kernel supports hd in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} heads per KV head, got hd={hd}, "
                         f"group={H // KV}")
    if not 1 <= valid_len <= S:
        raise ValueError(f"valid_len {valid_len} outside [1, {S}]")
    scale = _default_scale(hd) if scale is None else scale
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    rc = build.load("decode_attn").decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, S, hd, int(valid_len), float(scale),
        int(k.dtype == torch.float8_e4m3fn), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attn")
    build.LAUNCHES["decode_attn"] += 1
    return out
