"""One-token GQA decode attention: the Hopper kernel
(``csrc/decode_attn.cu``), its plain PyTorch version and the
partial-attention algebra the kernel's sequence split carries.

Replaces ``src/repro/kernels/decode_attn.py::_kernel``.  Shapes:

    q: (B, H, hd) bf16            — current token's queries
    k, v: (B, S, KV, hd) bf16 or float8_e4m3fn cache
    valid_len: int                — cache slots < valid_len attend
    out: (B, H, hd) f32

Query head ``h`` reads KV head ``h // (H // KV)``; slots at or past
``valid_len`` get a finite -1e30 score.  ``scale`` defaults to
``1 / sqrt(hd)``; the model's decode step passes queries already scaled
(``scale=1``), as the reference decode step's attention computes them.

The kernel splits the valid positions of each (batch row, KV head) into
blocks of :func:`split_size` positions, each block's online-softmax
statistics ``(m, l, acc)`` being what :func:`attention_partial` computes
for its slice, and merges them as :func:`combine_partials` does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import build

MAX_GROUP = 16          # query heads per KV head the kernel carries
HEAD_DIMS = (32, 64, 128)
_MASKED = -1e30
# Positions per block of the kernel's sequence split, at the least: one
# tile of the kernel, and the unit its split sizes are multiples of.
SPLIT_POSITIONS = 32
# Blocks the split aims at, per SM of the card, once the blocks merge
# through device memory.
BLOCKS_PER_SM = 2
# Blocks per (batch row, KV head) when they merge through device memory:
# the last of them reads every partial, so the split stops at
# MERGE_SPLITS blocks while each takes MERGE_TILES tiles of
# SPLIT_POSITIONS or fewer; longer contexts, where a block's steps cost
# more than the merge, take up to MAX_SPLITS (the kernel's kMaxSplits).
MERGE_SPLITS = 48
MERGE_TILES = 8
MAX_SPLITS = 64
# Up to CLUSTER_SPLITS blocks a row form a thread block cluster that
# merges on chip, with no trip through device memory (the kernel's
# kClusterSplits); the split takes that path while its blocks hold
# CLUSTER_TILES tiles or fewer (two steps of the kernel): up to 2048
# positions.  Measured on an H100 (chip_variants.py): the cluster wins at
# 2048 and ties at 3072, the merge through memory wins from 4096.
CLUSTER_SPLITS = 16
CLUSTER_TILES = 4

AttnPartial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (m, l, acc)


def split_size(valid_len: int, rows: int, sms: int) -> int:
    """Positions per block when ``rows`` (batch rows × KV heads) each
    attend over ``valid_len`` slots on a card of ``sms`` SMs, a multiple
    of :data:`SPLIT_POSITIONS`: spread over :data:`CLUSTER_SPLITS` blocks
    a row while that gives each :data:`CLUSTER_TILES` tiles or fewer;
    else over :data:`MERGE_SPLITS` blocks while each takes
    :data:`MERGE_TILES` tiles or fewer, then :data:`MAX_SPLITS` — and
    never more than :data:`BLOCKS_PER_SM` blocks per SM in all."""
    tiles = -(-valid_len // SPLIT_POSITIONS)
    if tiles <= CLUSTER_SPLITS * CLUSTER_TILES:
        return SPLIT_POSITIONS * -(-tiles // CLUSTER_SPLITS)
    per_block = -(-tiles // MERGE_SPLITS)
    if per_block > MERGE_TILES:
        per_block = -(-tiles // MAX_SPLITS)
    per_block = max(per_block, -(-tiles * rows // (BLOCKS_PER_SM * sms)))
    return SPLIT_POSITIONS * per_block


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# Merge counters through device memory, per (device, stream): zeroed once;
# the kernel sets each back to 0 when its row's merge is done.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[(device.index, stream)] = buf
    return buf


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


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[int] = None,
                      scale: Optional[float] = None) -> AttnPartial:
    """Online-softmax statistics of one KV chunk for one decode step
    (``repro.kernels.decode_attn.attention_partial``): running max
    ``m`` (B, H), denominator ``l`` (B, H) and unnormalised accumulator
    ``acc`` (B, H, hd), all f32, so that ``acc / l`` is the chunk's own
    attention output.  ``valid_len`` masks the chunk's slots past it with
    the kernel's finite fill."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qf, k.float()) * (
        _default_scale(hd) if scale is None else scale)
    if valid_len is not None:
        pos = torch.arange(S, device=q.device)
        s = torch.where(pos < valid_len, s, torch.full_like(s, _MASKED))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return (m.reshape(B, H), p.sum(dim=-1).reshape(B, H),
            acc.reshape(B, H, hd))


def combine_partials(parts: Sequence[AttnPartial]) -> torch.Tensor:
    """Merge per-chunk ``(m, l, acc)`` triples into the attention output
    (B, H, hd) f32 (``repro.kernels.decode_attn.combine_partials``):
    each pair is rescaled to the joint max and added, left to right."""
    m, l, acc = parts[0]
    for m2, l2, acc2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        c1, c2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
        l = l * c1 + l2 * c2            # noqa: E741 — flash notation
        acc = acc * c1[..., None] + acc2 * c2[..., None]
        m = m_new
    return acc / l[..., None]


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
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("decode attention kernel needs 16-byte aligned "
                         "q, k and v")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"kernel supports hd in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} heads per KV head, got hd={hd}, "
                         f"group={H // KV}")
    if not 1 <= valid_len <= S:
        raise ValueError(f"valid_len {valid_len} outside [1, {S}]")
    scale = _default_scale(hd) if scale is None else scale
    chunk = split_size(valid_len, B * KV, _sms(q.device.index))
    n_split = -(-valid_len // chunk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    partials = counters = None
    if n_split > CLUSTER_SPLITS:       # the blocks merge through memory
        partials = torch.empty(B * H * n_split * (hd + 2),
                               dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, B * KV)
    rc = build.load("decode_attn").decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if counters is None else counters.data_ptr(),
        B, H, KV, S, hd, int(valid_len), chunk, float(scale),
        int(k.dtype == torch.float8_e4m3fn), q.device.index, stream)
    build.check(rc, "decode_attn")
    build.LAUNCHES["decode_attn"] += 1
    return out
