"""One-token GQA decode attention: the Hopper kernel
(``csrc/decode_attn.cu``), its plain PyTorch version and the
partial-attention algebra the kernel's sequence split carries.

Replaces ``src/repro/kernels/decode_attn.py::_kernel``.  Shapes:

    q: (B, H, hd) bf16            — current token's queries
    k, v: (B, S, KV, hd) bf16 or float8_e4m3fn cache
    valid_len: int, or a 0-d integer tensor on q's device
                                  — cache slots < valid_len attend
    out: (B, H, hd) f32

A tensor ``valid_len`` is the decode step's position + 1 as the
reference's jitted step traces it: nothing reads it on the host.  The
kernel's entry for it (``decode_attn_devlen``) launches a grid fixed by
the capacity S (:func:`devlen_grid`), so one launch serves every position
and a CUDA graph replays it; each block reads the length on the card,
clamped to [1, S] (the plain version clamps it the same way), and takes
its range of the split that length gets (:func:`device_split`).

Query head ``h`` reads KV head ``h // (H // KV)``; slots at or past
``valid_len`` get a finite -1e30 score.  ``scale`` defaults to
``1 / sqrt(hd)``; the model's decode step passes queries already scaled
(``scale=1``), as the reference decode step's attention computes them.

The kernel splits the valid positions of each (batch row, KV head) into
blocks of :func:`split_size` positions (:func:`device_split` for a device
length), each block's online-softmax statistics ``(m, l, acc)`` being
what :func:`attention_partial` computes for its slice, and merges them as
:func:`combine_partials` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

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
# The device-length entry's blocks carry hd x (8 or 16) heads; where that
# is WIDE_BLOCK or more (two blocks an SM), its rule spreads a short
# context over at most WIDE_CLUSTER blocks a row, each taking up to
# CLUSTER_SPLITS * CLUSTER_TILES / WIDE_CLUSTER tiles, so the cluster's
# range stays 2048 positions.  Measured on an H100 (chip_smoke.py's
# [kernel] lines): 16-block clusters of llava-next-34b's blocks (hd 128,
# 8 heads) take 1.5 µs more than 8-block ones at 1 and 65 positions of
# 640, and 0.3 µs more at 576; qwen2-0.5b's (hd 64, three an SM) lose
# under 0.15 µs to 16-block clusters at short lengths and gain 1 µs at
# 576.
WIDE_CLUSTER = 8
WIDE_BLOCK = 1024

AttnPartial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (m, l, acc)


def _split_tiles(tiles: int, rows: int, sms: int,
                 cluster: int = CLUSTER_SPLITS) -> int:
    """Tiles per block of :func:`split_size` for ``tiles`` tiles a row,
    short contexts spread over ``cluster`` blocks — the rule the kernel's
    device-length entry applies on the card
    (``csrc/decode_attn.cu::split_tiles``, with :func:`split_rule`)."""
    if tiles <= cluster * (CLUSTER_SPLITS * CLUSTER_TILES // cluster):
        return -(-tiles // cluster)
    per_block = -(-tiles // MERGE_SPLITS)
    if per_block > MERGE_TILES:
        per_block = -(-tiles // MAX_SPLITS)
    return max(per_block, -(-tiles * rows // (BLOCKS_PER_SM * sms)))


def split_size(valid_len: int, rows: int, sms: int) -> int:
    """Positions per block when ``rows`` (batch rows × KV heads) each
    attend over ``valid_len`` slots on a card of ``sms`` SMs, a multiple
    of :data:`SPLIT_POSITIONS`: spread over :data:`CLUSTER_SPLITS` blocks
    a row while that gives each :data:`CLUSTER_TILES` tiles or fewer;
    else over :data:`MERGE_SPLITS` blocks while each takes
    :data:`MERGE_TILES` tiles or fewer, then :data:`MAX_SPLITS` — and
    never more than :data:`BLOCKS_PER_SM` blocks per SM in all."""
    return SPLIT_POSITIONS * _split_tiles(-(-valid_len // SPLIT_POSITIONS),
                                          rows, sms)


def block_cluster(hd: int, group: int) -> int:
    """Blocks a row over which the device-length entry's rule spreads a
    context of 2048 positions or fewer: :data:`CLUSTER_SPLITS`, or
    :data:`WIDE_CLUSTER` where a block carries ``hd`` x its heads (8 for
    a ``group`` of 8 or fewer, else 16) of :data:`WIDE_BLOCK` or more."""
    heads = 8 if group <= 8 else 16
    return WIDE_CLUSTER if hd * heads >= WIDE_BLOCK else CLUSTER_SPLITS


def split_rule(cluster: int = CLUSTER_SPLITS) -> Tuple[int, ...]:
    """The rule's constants as the device-length entry takes them (the
    card's SM count follows), short contexts spread over ``cluster``
    blocks of up to ``CLUSTER_SPLITS * CLUSTER_TILES / cluster`` tiles."""
    return (SPLIT_POSITIONS, cluster,
            CLUSTER_SPLITS * CLUSTER_TILES // cluster, MERGE_SPLITS,
            MERGE_TILES, MAX_SPLITS, BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def grid_splits(capacity: int, rows: int, sms: int,
                cluster: int = CLUSTER_SPLITS) -> int:
    """Blocks a row of the device-length entry's grid over a cache of
    ``capacity`` slots: the most that the rule (:func:`_split_tiles`
    with ``cluster``) gives any length in [1, capacity], so that every
    length's split fits the one grid."""
    return max(-(-t // _split_tiles(t, rows, sms, cluster))
               for t in range(1, -(-capacity // SPLIT_POSITIONS) + 1))


def device_split(valid_len: int, capacity: int, rows: int, sms: int,
                 cluster: int = CLUSTER_SPLITS) -> Tuple[int, int]:
    """``(active, chunk)``: the split the device-length entry's blocks
    compute on the card from the length they read — ``valid_len`` clamped
    to [1, capacity], cut into blocks of ``chunk`` positions by the rule
    with ``cluster`` (:func:`block_cluster`; :data:`CLUSTER_SPLITS` is
    :func:`split_size`'s own), the first ``active`` of the grid's
    :func:`grid_splits` blocks a row holding them."""
    valid = min(max(int(valid_len), 1), capacity)
    tiles = -(-valid // SPLIT_POSITIONS)
    per = _split_tiles(tiles, rows, sms, cluster)
    return -(-tiles // per), SPLIT_POSITIONS * per


def devlen_grid(capacity: int, rows: int, sms: int, hd: int,
                group: int) -> int:
    """Blocks a row the device-length entry launches over ``capacity``
    slots for blocks of ``hd`` and ``group`` heads: :func:`grid_splits`
    with :func:`block_cluster`."""
    return grid_splits(capacity, rows, sms, block_cluster(hd, group))


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_grid(q: torch.Tensor, k: torch.Tensor) -> int:
    """:func:`devlen_grid` for these CUDA tensors' shapes and card."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    return devlen_grid(S, B * KV, _sms(q.device.index), hd, H // KV)


def device_cluster(q: torch.Tensor, k: torch.Tensor) -> int:
    """:func:`block_cluster` for these tensors' shapes."""
    return block_cluster(q.shape[2], q.shape[1] // k.shape[2])


# Merge counters through device memory, per (device, stream): zeroed once;
# the kernel sets each back to 0 when its row's merge is done.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((device.index, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # allocated now, the buffer would be memory of the graph's
            # private pool, and later eager calls on this stream would
            # share it
            raise RuntimeError(
                "decode attention's merge counters for this stream do not "
                "exist yet: run the step once on the capture stream before "
                "a CUDA graph captures it")
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[(device.index, stream)] = buf
    return buf


def _default_scale(hd: int) -> float:
    return 1.0 / (hd ** 0.5)


Length = Union[int, torch.Tensor]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: Length,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch decode attention in f32 (any device).  A tensor
    ``valid_len`` is clamped to [1, S], as the kernel clamps it."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    scale = _default_scale(hd) if scale is None else scale
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.clamp(1, S)
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


def _check_length(valid_len: torch.Tensor, q: torch.Tensor) -> None:
    if valid_len.dim() != 0 or valid_len.is_floating_point() \
            or valid_len.is_complex() or valid_len.dtype == torch.bool:
        raise TypeError(f"a tensor valid_len must be a 0-d integer tensor, "
                        f"got {valid_len.dtype} of shape "
                        f"{tuple(valid_len.shape)}")
    if valid_len.device != q.device:
        raise ValueError(f"valid_len on {valid_len.device}, q on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: Length,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention on the tensors' device: the CUDA kernel on the
    card, :func:`decode_attention_plain` on the CPU.  On the ``meta``
    device (a dry run's trace) only the shapes are checked and an empty
    output returned: nothing is computed or launched.  An int
    ``valid_len`` takes the kernel's host-length entry (counted as
    ``decode_attn``), a 0-d tensor on q's device its device-length entry
    (``decode_attn_devlen``), in eager mode as under a CUDA graph's
    capture."""
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
    on_device = isinstance(valid_len, torch.Tensor)
    if on_device:
        _check_length(valid_len, q)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid_len, scale)
    if not on_device and not 1 <= valid_len <= S:
        raise ValueError(f"valid_len {valid_len} outside [1, {S}]")
    if q.device.type == "meta" and k.is_meta and v.is_meta:
        return torch.empty((B, H, hd), dtype=torch.float32, device="meta")
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
    scale = _default_scale(hd) if scale is None else scale
    rows, sms = B * KV, _sms(q.device.index)
    if on_device:      # the capacity's grid; the blocks split the length
        n_split = device_grid(q, k)
    else:
        chunk = split_size(int(valid_len), rows, sms)
        n_split = -(-int(valid_len) // chunk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    partials = counters = None
    if n_split > CLUSTER_SPLITS:       # the blocks merge through memory
        partials = torch.empty(B * H * n_split * (hd + 2),
                               dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, B * KV)
    lib = build.load("decode_attn")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if counters is None else counters.data_ptr())
    tail = (float(scale), int(k.dtype == torch.float8_e4m3fn),
            q.device.index, stream)
    if on_device:
        length = valid_len.to(torch.int32)     # no copy when already int32
        consts = split_rule(block_cluster(hd, H // KV))
        rule = (ctypes.c_int * (len(consts) + 1))(*consts, sms)
        rc = lib.decode_attn_devlen(*ptrs, length.data_ptr(), B, H, KV, S,
                                    hd, n_split, rule, *tail)
        name = "decode_attn_devlen"
    else:
        rc = lib.decode_attn(*ptrs, B, H, KV, S, hd, int(valid_len), chunk,
                             *tail)
        name = "decode_attn"
    build.check(rc, name)
    build.LAUNCHES[name] += 1
    return out
