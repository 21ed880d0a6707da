"""PNM page scoring: the Hopper kernel (``csrc/pnm_score.cu``), its plain
PyTorch version, the tier's ragged-page entry point and the host-side
top-k selection.

Replaces ``src/repro/kernels/pnm_score.py::_score_kernel``.  The tier's
PNM gather (``core.tier.GatherReq``) decodes every candidate page at its
``score_view`` on the host and scores the pages here, on the tier's
device:

    score(page) = max over valid token rows t of  <row_t, digest>

in f32, ``-inf`` for a page with no valid row, NaN when any valid row's
dot is NaN (as ``np.max`` propagates it).  A page's score is bitwise the
same whatever batch it is scored in: each row's dot is summed in one
fixed order (products rounded once, then a halving tree over the
channels zero-padded to a power of two of at least 32), which the kernel
and :func:`page_scores_plain` share, so the two agree bit for bit.  That
is what makes equal pages tie exactly (the tie then breaks by candidate
position in :func:`topk_select`) and what keeps a fleet's per-shard
scores, each shard padding its own batch, identical to one device's.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from .. import devices
from . import build

MAX_CHANNELS = 1024      # the kernel's shared-memory digest


def _tree_width(channels: int) -> int:
    """Channels padded to the summation tree's width: a power of two,
    at least one warp (32)."""
    width = 32
    while width < channels:
        width *= 2
    return width


def page_scores_plain(pages: torch.Tensor, valid: torch.Tensor,
                      digest: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch scoring (any device): ``(P, T, C)`` bf16 bit
    patterns (int16/uint16) with ``(P,)`` valid row counts and a ``(C,)``
    f32 digest → ``(P,)`` f32.  Element-wise ops only, in the kernel's
    summation order, so no reduction depends on ``P`` or ``T``."""
    P, T, C = pages.shape
    if T == 0:
        return torch.full((P,), float("-inf"), device=pages.device)
    prod = pages.view(torch.bfloat16).float() * digest.float()
    prod = torch.nn.functional.pad(prod, (0, _tree_width(C) - C))
    while prod.shape[-1] > 1:
        half = prod.shape[-1] // 2
        prod = prod[..., :half] + prod[..., half:]
    dots = prod[..., 0]                                   # (P, T)
    rows = torch.arange(T, device=pages.device)
    mask = rows[None, :] < valid.to(pages.device)[:, None]
    return torch.where(mask, dots, float("-inf")).amax(dim=1)


def page_scores(pages: torch.Tensor, valid: torch.Tensor,
                digest: torch.Tensor) -> torch.Tensor:
    """Score a padded page stack on the tensors' device: the CUDA kernel
    on the card, :func:`page_scores_plain` on the CPU."""
    if pages.dim() != 3 or valid.shape != pages.shape[:1] \
            or digest.shape != pages.shape[2:]:
        raise ValueError(f"bad shapes pages {tuple(pages.shape)} valid "
                         f"{tuple(valid.shape)} digest {tuple(digest.shape)}")
    if pages.dtype not in (torch.int16, torch.uint16):
        raise TypeError(f"pages must be bf16 patterns in int16/uint16, got "
                        f"{pages.dtype}")
    if digest.dtype != torch.float32:
        raise TypeError(f"digest must be float32, got {digest.dtype}")
    if pages.device.type == "cpu":
        return page_scores_plain(pages, valid, digest)
    if pages.device.type != "cuda" or valid.device != pages.device \
            or digest.device != pages.device:
        raise ValueError(f"page scoring needs pages, valid and digest on one "
                         f"CUDA device, got {pages.device}/{valid.device}/"
                         f"{digest.device}")
    P, T, C = pages.shape
    if T < 1 or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"kernel takes 1 <= T and 1 <= C <= {MAX_CHANNELS}, "
                         f"got T={T}, C={C}")
    if valid.dtype != torch.int32:
        raise TypeError(f"valid must be int32, got {valid.dtype}")
    if not (pages.is_contiguous() and valid.is_contiguous()
            and digest.is_contiguous()):
        raise ValueError("page scoring kernel needs contiguous tensors")
    out = torch.empty((P,), dtype=torch.float32, device=pages.device)
    rc = build.load("pnm_score").pnm_score(
        pages.data_ptr(), valid.data_ptr(), digest.data_ptr(),
        out.data_ptr(), P, T, C, pages.device.index,
        torch.cuda.current_stream(pages.device).cuda_stream)
    build.check(rc, "pnm_score")
    build.LAUNCHES["pnm_score"] += 1
    return out


def page_scores_u16(pages: Sequence[np.ndarray], digest: np.ndarray,
                    device: Union[str, torch.device, None] = None
                    ) -> np.ndarray:
    """Score raw device payloads on ``device`` (default: the card): each
    page is a uint16 (bf16-pattern) array whose elements factor into
    ``digest.size``-channel rows.  Ragged pages are padded to the longest
    and masked → ``(P,)`` f32 on the host."""
    digest = np.asarray(digest, dtype=np.float32)
    if not pages:
        return np.zeros((0,), dtype=np.float32)
    C = digest.size
    rows = []
    for p in pages:
        flat = np.ascontiguousarray(p, dtype=np.uint16).ravel()
        if flat.size % C:
            raise ValueError(f"page of {flat.size} elems does not factor "
                             f"into {C}-channel rows")
        rows.append(flat.reshape(-1, C))
    valid = np.array([r.shape[0] for r in rows], dtype=np.int32)
    padded = np.zeros((len(rows), max(1, int(valid.max())), C), np.uint16)
    for i, r in enumerate(rows):
        padded[i, : r.shape[0]] = r
    dev = devices.resolve(device)
    out = page_scores(torch.from_numpy(padded.view(np.int16)).to(dev),
                      torch.from_numpy(valid).to(dev),
                      torch.from_numpy(digest).to(dev))
    return out.cpu().numpy()


def topk_select(scores: np.ndarray, k: int) -> List[int]:
    """Deterministic top-k: descending score, ties broken by candidate
    position (stable across shard counts and sync/async paths); NaN
    ranks last.  ``k`` past the candidate count clamps; ``k=0`` selects
    nothing."""
    scores = np.asarray(scores)
    n = scores.size
    if n == 0 or k <= 0:
        return []
    order = np.lexsort((np.arange(n), -scores))
    return [int(i) for i in order[: min(k, n)]]
