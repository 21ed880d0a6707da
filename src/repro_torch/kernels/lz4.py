"""Device-resident LZ4 match pipeline (paper §IV-E's 32-lane engine).

The encoder's hot path — match-table build, previous-occurrence
resolution, LCP extension and greedy selection — over a whole flush
group's concatenated (plane, block) streams.  On the card it is one
launch and one copy back:

1. **match** — ``csrc/lz4_match.cu`` (replacing the reference's whole
   jitted ``_device_match_impl``, its prep ``_prep_kernel`` included):
   from the slab's bytes, per stream the words and hashes, the previous
   same-hash position, the candidate filter (window / end-of-block /
   run-stride rules), the match lengths (run end for offset-1 runs, word
   gallop plus an exact tail otherwise) and the greedy chain (pointer
   doubling), every stream of the slab in one launch, events in
   per-stream rows;
2. the events and counts come back in one copy; streams are ascending
   and events rise within a stream, so dropping the unused row slots
   (:func:`compact_events`) leaves them sorted by position.

:func:`lz4_match` is that wrapper; for a slab on the CPU it runs
:func:`match_plain`, the same function as PyTorch operations (the prep's
plain version, a stable sort of stream-namespaced hash keys, reverse
cumulative minima for the next-candidate and run-end tables, then
Python-driven rounds that advance every live stream by one match), which
is also what the card's kernel is held against.  :func:`match_chain_plain`
follows the kernel's own selection rule in PyTorch operations (chain-end
lengths, next candidates by rank, the chain by pointer doubling); only
the tests run it.  The prep's kernel (``csrc/lz4_prep.cu``,
:func:`lz4_prep`) stays as the reference's ``_prep_kernel`` on its own.

:func:`match_events_slab` dispatches on where the slab lives: a tensor on
the card takes the kernel, host data takes the vectorized-numpy twin
(the CPU production encoder).  ``force="device"`` runs :func:`lz4_match`
on a tensor's device (:func:`match_plain` on the CPU), ``force="numpy"``
pins the twin.  All are byte-identical to the scalar reference
``codec._lz4_events_scalar``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import spans
from . import build

# LZ4 block-format constants + repo match-policy knobs (shared with the
# codec's scalar reference, which imports them from here).
HASH_LOG = 13
HASH_SIZE = 1 << HASH_LOG
MIN_MATCH = 4
MFLIMIT = 12          # a match must not start within the last 12 bytes
LAST_LITERALS = 5     # the last 5 bytes of a stream are always literals
RUN_STRIDE = 4        # interior byte-run positions keep a candidate only
                      # every RUN_STRIDE bytes (re-anchor bound)
_HASH_MUL = 2654435761

_EMPTY = (np.empty(0, np.int64),) * 3


def match_events_slab(slab, starts, ends,
                      force: str | None = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy LZ4 match events for every stream of a concatenated slab.

    ``slab`` is a flat uint8 buffer: numpy, or a tensor (on the card on
    the write path — the packed planes straight from the pack kernel).
    ``starts``/``ends`` bound each stream's half-open byte range, disjoint
    and ascending (gaps are allowed and never touched).  Returns
    ``(pos, dist, mlen)`` int64 arrays sorted by global position: the
    matches a per-stream scalar scan would select, bit for bit.
    """
    starts = np.asarray(starts, dtype=np.int64).ravel()
    ends = np.asarray(ends, dtype=np.int64).ravel()
    if starts.size == 0:
        return _EMPTY
    on_card = isinstance(slab, torch.Tensor) and slab.device.type == "cuda"
    if force == "device" or (force is None and on_card):
        if not isinstance(slab, torch.Tensor):
            slab = torch.from_numpy(np.array(slab, dtype=np.uint8).ravel())
        return lz4_match(slab.reshape(-1), starts, ends)
    if isinstance(slab, torch.Tensor):
        slab = slab.cpu().numpy()
    buf = np.asarray(slab, dtype=np.uint8).ravel()
    return _match_events_numpy(buf, starts, ends)


# ---------------------------------------------------------------------------
# prep: Hopper kernel + plain PyTorch version
# ---------------------------------------------------------------------------

def prep_plain(buf: torch.Tensor):
    """Plain PyTorch prep over a flat uint8 slab → ``(w, h, runb)`` int32
    tensors of length N (bytes past the end read as 0; ``w`` holds the
    uint32 word's bits).  int64
    arithmetic: the 32x32-bit hash product is split so it never leaves
    int64's range."""
    n = buf.numel()
    b = torch.nn.functional.pad(buf.to(torch.int64), (0, 3))
    b0, b1 = b[:n], b[1 : n + 1]
    w = b0 | (b1 << 8) | (b[2 : n + 2] << 16) | (b[3 : n + 3] << 24)
    lo, hi = w & 0xFFFF, w >> 16
    prod = (lo * _HASH_MUL + (((hi * _HASH_MUL) & 0xFFFF) << 16)) & 0xFFFFFFFF
    h = prod >> (32 - HASH_LOG)
    w32 = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w32.to(torch.int32), h.to(torch.int32), (b0 != b1).to(torch.int32)


def lz4_prep(buf: torch.Tensor):
    """Prep of a flat uint8 slab (any start) on its device: the CUDA kernel
    on the card, :func:`prep_plain` on the CPU.  Returns ``(w, h, runb)``."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"prep expects a flat uint8 slab, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    if buf.device.type == "cpu":
        return prep_plain(buf)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not buf.is_contiguous():
        raise ValueError("prep kernel needs a contiguous slab")
    n = buf.numel()
    w, h, run = (torch.empty(n, dtype=torch.int32, device=buf.device)
                 for _ in range(3))
    rc = build.load("lz4_prep").lz4_prep(
        buf.data_ptr(), w.data_ptr(), h.data_ptr(), run.data_ptr(), n,
        buf.device.index,
        torch.cuda.current_stream(buf.device).cuda_stream)
    build.check(rc, "lz4_prep")
    build.LAUNCHES["lz4_prep"] += 1
    return w, h, run


# ---------------------------------------------------------------------------
# vectorized-numpy twin (CPU production encoder)
# ---------------------------------------------------------------------------

def _words_hashes(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4-byte LE words + hashes for positions 0..N-4 (hash as uint16, so
    the table sort takes numpy's radix path)."""
    w = buf[3:].astype(np.uint32)
    np.left_shift(w, np.uint32(8), out=w)
    np.bitwise_or(w, buf[2:-1], out=w)
    np.left_shift(w, np.uint32(8), out=w)
    np.bitwise_or(w, buf[1:-2], out=w)
    np.left_shift(w, np.uint32(8), out=w)
    np.bitwise_or(w, buf[:-3], out=w)
    h = w * np.uint32(_HASH_MUL)
    np.right_shift(h, np.uint32(32 - HASH_LOG), out=h)
    return w, h.astype(np.uint16)


def _stream_ids(n_pos: int, starts: np.ndarray,
                ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (sid, covered) maps for positions 0..n_pos-1; ``sid`` is
    meaningful only where ``covered``."""
    s = starts[starts < n_pos]
    e = np.minimum(ends, n_pos)
    marks = np.zeros(n_pos + 1, dtype=np.int64)
    np.add.at(marks, s, 1)
    sid = np.cumsum(marks[:-1]) - 1
    cover = np.zeros(n_pos + 1, dtype=np.int64)
    np.add.at(cover, s, 1)
    np.subtract.at(cover, e, 1)
    covered = np.cumsum(cover[:-1]) > 0
    return sid, covered


_SWEEP_CAP = 32        # capped-LCP sweep bound for offsets > 1 (selected
                       # matches that hit it are galloped to the true LCP)
_GALLOP_EAGER = 128    # ≤ this many capped candidates → gallop them all
                       # up front; above it gallop lazily on selection


def _gallop(bb: bytes, p: int, c: int, m: int, mx: int) -> int:
    """True LCP of positions ``p`` and ``c`` from ``m``, capped at ``mx``."""
    while m + 32 <= mx and bb[c + m : c + m + 32] == bb[p + m : p + m + 32]:
        m += 32
    while m < mx and bb[c + m] == bb[p + m]:
        m += 1
    return m


def _match_events_numpy(buf: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray):
    """The numpy match twin — the CPU production encoder.

    Run-collapses the hash-table sort: positions inside byte runs resolve
    to ``pos - 1`` without the table, and maximal runs intersected with
    streams (segments) generate the run candidates and their exact match
    lengths by ragged arithmetic.  The remaining passes (lookup filter,
    capped-sweep LCP, pointer-jump greedy rounds) are O(candidates).
    """
    N = int(buf.size)
    if N < MIN_MATCH:
        return _EMPTY
    w, h = _words_hashes(buf)
    S = int(starts.size)
    sizes = ends - starts
    cnt = np.maximum(sizes - 3, 0)
    ccum = np.cumsum(cnt)
    W = int(ccum[-1])
    if W == 0:
        return _EMPTY
    cbase = ccum - cnt
    sid_dt = np.uint16 if S <= 0xFFFF else np.int64
    sid_w = np.repeat(np.arange(S, dtype=sid_dt), cnt)
    adj = (starts - cbase).astype(np.int32)

    # --- byte-run segmentation ----------------------------------------
    bnd = np.flatnonzero(buf[1:] != buf[:-1])    # last index of each run
    if bnd.size:
        li = np.flatnonzero(np.diff(bnd) >= MIN_MATCH + 1)
        ra = bnd[li] + 1
        rb = bnd[li + 1]
        if int(bnd[0]) >= MIN_MATCH:                # run before first bnd
            ra = np.concatenate(([0], ra))
            rb = np.concatenate(([bnd[0]], rb))
        if N - 1 - int(bnd[-1]) >= MIN_MATCH + 1:   # run after last bnd
            ra = np.concatenate((ra, [bnd[-1] + 1]))
            rb = np.concatenate((rb, [N - 1]))
    elif N >= MIN_MATCH + 1:                        # whole buf one run
        ra = np.asarray([0], dtype=np.int64)
        rb = np.asarray([N - 1], dtype=np.int64)
    else:
        ra = rb = np.empty(0, dtype=np.int64)
    if ra.size:
        s0 = np.minimum(np.searchsorted(ends, ra + 1, side="right"), S - 1)
        s1 = np.minimum(np.searchsorted(ends, rb - 3, side="right"), S - 1)
        nspan = s1 - s0 + 1
        segc = np.cumsum(nspan)
        nseg0 = int(segc[-1])
        segrun = np.repeat(np.arange(ra.size, dtype=np.int64), nspan)
        segsid = (np.arange(nseg0, dtype=np.int64)
                  - np.repeat(segc - nspan - s0, nspan))
        lo = np.maximum(ra[segrun] + 1, starts[segsid] + 1)
        hi = np.minimum(rb[segrun] - 3, ends[segsid] - 4)
        keep = lo <= hi
        segrun, segsid = segrun[keep], segsid[keep]
        lo, hi = lo[keep], hi[keep]
    else:
        segrun = segsid = lo = hi = np.empty(0, dtype=np.int64)

    # --- hash-table sort over the run-collapsed subset -----------------
    jlo = cbase[segsid] + (lo - starts[segsid])
    jhi = jlo + (hi - lo)
    klo = np.concatenate(([0], jhi))
    khi = np.concatenate((jlo, [W]))
    klen = khi - klo
    kcum = np.cumsum(klen)
    subset = (np.arange(int(kcum[-1]), dtype=np.int32)
              + np.repeat((klo - (kcum - klen)).astype(np.int32), klen))
    irl_sub = np.zeros(subset.size, dtype=bool)
    irl_sub[np.searchsorted(subset, jhi.astype(np.int32))] = True
    ssub = sid_w[subset]
    psub = subset + adj[ssub]
    hsub = h[psub]
    if S <= 0xFFFF:
        # one stable uint16 radix pass on the wrapped (sid, hash) key;
        # the sid comparison below cuts the seams between aliased groups
        key16 = ((ssub.astype(np.uint16) << np.uint16(HASH_LOG))
                 + hsub)
        order = np.argsort(key16, kind="stable")
        k16o = key16[order]
        so = ssub[order]
        same = (k16o[1:] == k16o[:-1]) & (so[1:] == so[:-1])
    else:  # pragma: no cover - >65535 streams per flush group
        skeys = (ssub.astype(np.int64) << np.int64(HASH_LOG)) | hsub
        order = np.argsort(skeys, kind="stable")
        ks = skeys[order]
        same = ks[1:] == ks[:-1]
    cand_idx = np.flatnonzero(same & ~irl_sub[order[1:]])
    prev_sub = np.full(subset.size, -1, dtype=np.int32)
    prev_sub[order[cand_idx + 1]] = order[cand_idx]

    # --- general candidates: window + word + end-of-stream rules -------
    gsel = np.flatnonzero(prev_sub >= 0)
    pj = psub[gsel]
    cj = psub[prev_sub[gsel]]
    okg = (pj - cj <= 0xFFFF) & (w[pj] == w[cj])
    pj, cj = pj[okg], cj[okg]
    sid_g = ssub[gsel[okg]]
    okg = pj < ends[sid_g] - MFLIMIT
    pj, cj, sid_g = pj[okg], cj[okg], sid_g[okg]

    # --- run candidates + exact match lengths, straight off segments ---
    if lo.size:
        ends_seg = ends[segsid]
        hi2 = np.minimum(hi, ends_seg - (MFLIMIT + 1))
        f0 = lo + ((starts[segsid] - lo) % RUN_STRIDE)
        has = lo <= hi2
        nstr = np.where(has & (f0 <= hi2),
                        (hi2 - f0) // RUN_STRIDE + 1, 0)
        extra = (has & (f0 != lo)).astype(np.int64)
        tc = nstr + extra
        tcum = np.cumsum(tc)
        segi = np.repeat(np.arange(tc.size, dtype=np.int64), tc)
        within = (np.arange(int(tcum[-1]), dtype=np.int64)
                  - np.repeat(tcum - tc, tc))
        ex_i = extra[segi]
        pos_r = np.where(ex_i > within, lo[segi],
                         f0[segi] + RUN_STRIDE * (within - ex_i))
        sid_r = segsid[segi]
        mlen_r = np.minimum(rb[segrun][segi] + 1 - pos_r,
                            ends_seg[segi] - LAST_LITERALS - pos_r)
    else:
        pos_r = sid_r = mlen_r = np.empty(0, dtype=np.int64)

    if pos_r.size == 0 and pj.size == 0:
        return _EMPTY

    # --- LCP for general candidates: capped word sweep -----------------
    cap_full = ends[sid_g] - LAST_LITERALS - pj
    cap_g = np.minimum(cap_full, _SWEEP_CAP)
    mlen_g = np.full(pj.size, MIN_MATCH, dtype=np.int64)
    alive = np.arange(pj.size)
    k = MIN_MATCH
    while alive.size:
        word_ok = cap_g[alive] >= k + 4
        alive = alive[word_ok]
        if alive.size == 0:
            break
        eqw = w[pj[alive] + k] == w[cj[alive] + k]
        fail = alive[~eqw]
        if fail.size:
            b0 = (buf[pj[fail] + k] == buf[cj[fail] + k]).astype(np.int64)
            b1 = b0 & (buf[pj[fail] + k + 1] == buf[cj[fail] + k + 1])
            b2 = b1 & (buf[pj[fail] + k + 2] == buf[cj[fail] + k + 2])
            mlen_g[fail] = k + b0 + b1 + b2
        alive = alive[eqw]
        k += 4
        mlen_g[alive] = k
    arr = np.flatnonzero(mlen_g < cap_g)
    for _ in range(3):      # ≤3-byte exact tail (word room ran out)
        if arr.size == 0:
            break
        eq = buf[pj[arr] + mlen_g[arr]] == buf[cj[arr] + mlen_g[arr]]
        arr = arr[eq]
        mlen_g[arr] += 1
        arr = arr[mlen_g[arr] < cap_g[arr]]
    flag_g = (mlen_g == _SWEEP_CAP) & (cap_full > _SWEEP_CAP)

    # --- merge run + general candidates in position order --------------
    C = int(pos_r.size + pj.size)
    pos_c = np.empty(C, dtype=np.int64)
    dist_c = np.empty(C, dtype=np.int64)
    mlen_c = np.empty(C, dtype=np.int64)
    flag_c = np.zeros(C + 1, dtype=bool)
    cap_c = np.empty(C, dtype=np.int64)
    if pj.size <= pos_r.size:
        at_g = np.arange(pj.size) + np.searchsorted(pos_r, pj)
        other = np.ones(C, dtype=bool)
        other[at_g] = False
        at_r = np.flatnonzero(other)
    else:
        at_r = np.arange(pos_r.size) + np.searchsorted(pj, pos_r)
        other = np.ones(C, dtype=bool)
        other[at_r] = False
        at_g = np.flatnonzero(other)
    pos_c[at_r] = pos_r
    pos_c[at_g] = pj
    dist_c[at_r] = 1
    dist_c[at_g] = pj - cj
    mlen_c[at_r] = mlen_r
    mlen_c[at_g] = mlen_g
    flag_c[at_g] = flag_g
    cap_c[at_g] = cap_full
    scnt = (np.bincount(sid_r, minlength=S)
            + np.bincount(sid_g, minlength=S))
    b_hi = np.cumsum(scnt)
    b_lo = b_hi - scnt
    bhi_c = np.repeat(b_hi, scnt)

    # dense rank map: cs[q] = #candidates with pos < q
    widths = np.diff(np.concatenate(([-1], pos_c, [N])))
    cs = np.repeat(np.arange(C + 1, dtype=np.int64), widths)
    nxt_c = cs[pos_c + mlen_c]
    fl = np.flatnonzero(flag_c[:C])
    if 0 < fl.size <= _GALLOP_EAGER:
        bb = buf.tobytes()
        for node in fl:
            node = int(node)
            p = int(pos_c[node])
            mlen_c[node] = _gallop(bb, p, p - int(dist_c[node]),
                                   int(mlen_c[node]), int(cap_c[node]))
        nxt_c[fl] = cs[pos_c[fl] + mlen_c[fl]]
        flag_c[:] = False

    # --- greedy selection: pointer-jump rounds across all streams ------
    nxt_ext = np.append(np.where(nxt_c < bhi_c, nxt_c, C), C)
    cur = np.where(b_lo < b_hi, b_lo, C)
    rounds = []
    if not flag_c.any():
        live = True
        while live:
            for _ in range(8):
                rounds.append(cur)
                cur = nxt_ext[cur]
            live = bool((cur < C).any())
    else:  # lazy fallback: many capped candidates (long periodic data)
        bb = buf.tobytes()
        while (cur < C).any():
            if flag_c[cur].any():
                for ci in np.flatnonzero(flag_c[cur]):
                    node = int(cur[ci])
                    p = int(pos_c[node])
                    m = _gallop(bb, p, p - int(dist_c[node]),
                                int(mlen_c[node]), int(cap_c[node]))
                    mlen_c[node] = m
                    flag_c[node] = False
                    nj = int(cs[p + m])
                    nxt_ext[node] = nj if nj < bhi_c[node] else C
            rounds.append(cur)
            cur = nxt_ext[cur]
    if not rounds:
        return _EMPTY
    sel = np.stack(rounds).ravel(order="F")
    sel = sel[sel < C]
    return pos_c[sel], dist_c[sel], mlen_c[sel]


# ---------------------------------------------------------------------------
# match: Hopper kernel + plain PyTorch version, events in per-stream rows
# ---------------------------------------------------------------------------

def event_rows(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """First event row of each stream and the total, ``(S + 1,)``: a
    stream of n bytes gets n // MIN_MATCH + 1 rows (matches never overlap
    and are at least MIN_MATCH long)."""
    return np.concatenate(([0], np.cumsum((ends - starts) // MIN_MATCH + 1)))


def compact_events(ev: np.ndarray, count: np.ndarray, rows: np.ndarray):
    """``(3, E)`` event rows + per-stream counts → ``(pos, dist, mlen)``
    int64, the used rows in stream order (sorted by position: streams
    ascend and events rise within one)."""
    count = np.asarray(count, dtype=np.int64)
    skip = rows[:-1] - (np.cumsum(count) - count)   # unused rows before
    keep = np.arange(int(count.sum())) + np.repeat(skip, count)
    return tuple(ev[i, keep].astype(np.int64) for i in range(3))


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), dim=0).values.flip(0)


def match_rows_plain(buf: torch.Tensor, starts: np.ndarray,
                     ends: np.ndarray):
    """The match pipeline as PyTorch operations on ``buf``'s device:
    ``(3, E)`` int32 event rows (:func:`event_rows`) and ``(S,)`` counts,
    on that device.

    Positions are int32 on the device; every gather index is clamped
    first.  The greedy rounds are a Python loop whose test
    (``live.any()``) reads one flag back per round, with a gallop loop
    inside that reads one back per 4-byte step.
    """
    N = int(buf.numel())
    dev = buf.device
    i32 = torch.int32
    S = int(starts.size)
    row_start = event_rows(starts, ends)
    E = int(row_start[-1])
    count = torch.zeros(S, dtype=i32, device=dev)
    out = torch.zeros((3, E + 1), dtype=i32, device=dev)
    if N < MIN_MATCH:
        return out[:, :E], count
    # static geometry → dense masks (host-computed, uploaded once)
    npos = N - 3
    sid, covered = _stream_ids(npos, starts, ends)
    valid = covered & (np.arange(npos) + MIN_MATCH <= ends[sid])
    local = np.arange(npos) - starts[np.minimum(sid, S - 1)]
    nb = (ends - starts)[np.minimum(sid, S - 1)]
    start_ok = valid & (local < nb - MFLIMIT)
    stride_ok = (local >= 2) & (local % RUN_STRIDE != 0)

    def up(a, dtype=i32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    sid_t = up(sid)
    valid_t, start_ok_t, stride_ok_t = (up(a, torch.bool)
                                        for a in (valid, start_ok, stride_ok))
    starts_t, ends_t, rows_t = up(starts), up(ends), up(row_start[:-1])

    w, h, runb = lz4_prep(buf)
    w, h = w[:npos], h[:npos]
    iota = torch.arange(npos, dtype=i32, device=dev)
    BIG = S * HASH_SIZE + HASH_SIZE
    keys = torch.where(valid_t, sid_t * HASH_SIZE + h,
                       torch.tensor(BIG, dtype=i32, device=dev))
    sk, order = torch.sort(keys, stable=True)
    same = (sk[1:] == sk[:-1]) & (sk[1:] < BIG)
    prev = torch.full((npos,), -1, dtype=i32, device=dev)
    prev[order[1:]] = torch.where(same, order[:-1].to(i32),
                                  torch.tensor(-1, dtype=i32, device=dev))
    dist = iota - prev
    zero = torch.zeros(2, dtype=buf.dtype, device=dev)
    bufm2 = torch.cat([zero, buf[:-2]])[:npos]
    bufm1 = torch.cat([zero[:1], buf[:-1]])[:npos]
    ok = (start_ok_t & (prev >= 0) & (dist <= 0xFFFF)
          & (w == w[prev.clamp(0, npos - 1).long()]))
    ok &= ~((dist == 1) & stride_ok_t & (bufm2 == bufm1))
    # next-candidate-at-or-after + run-end tables: reverse cumulative mins
    ncand = _rev_cummin(torch.where(ok, iota, npos))
    run_last = _rev_cummin(torch.where(
        runb[: N - 1] > 0, torch.arange(N - 1, dtype=i32, device=dev), N - 1))
    run_last = torch.cat([run_last, torch.full((1,), N - 1, dtype=i32,
                                               device=dev)])

    sids = torch.arange(S, dtype=i32, device=dev)
    max_end = ends_t - LAST_LITERALS

    def cursor_of(p):
        c = ncand[p.clamp(0, npos - 1).long()]
        live = ((p < npos) & (c < npos)
                & (sid_t[c.clamp(0, npos - 1).long()] == sids))
        return torch.where(live, c, npos), live

    def lcp(p, d, live):
        cap = max_end - p
        c = p - d
        run = d == 1
        m_run = torch.minimum(run_last[p.clamp(0, N - 1).long()] - p + 1, cap)
        m = torch.full((S,), MIN_MATCH, dtype=i32, device=dev)
        gallop = live & ~run
        while True:     # word gallop: 4 bytes per round while words agree
            gi = (p + m).clamp(0, npos - 1).long()
            ci = (c + m).clamp(0, npos - 1).long()
            adv = gallop & (m + 4 <= cap) & (w[gi] == w[ci])
            m = m + 4 * adv.to(i32)
            if not bool(adv.any()):
                break
        for _ in range(3):      # exact ≤3-byte tail
            gi = (p + m).clamp(0, N - 1).long()
            ci = (c + m).clamp(0, N - 1).long()
            m = m + (gallop & (m < cap) & (buf[gi] == buf[ci])).to(i32)
        return torch.where(run, m_run, torch.where(live, m, MIN_MATCH))

    cur, live = cursor_of(starts_t)
    while bool(live.any()):
        p = cur.clamp(0, npos - 1)
        d = dist[p.long()]
        m = lcp(p, d, live)
        # dead lanes write the spare slot E, which is cut off below
        slot = torch.where(live, rows_t + count, E).long()
        out[:, slot] = torch.where(live, torch.stack([p, d, m]), 0)
        count = count + live.to(i32)
        cur, nlive = cursor_of(torch.where(live, p + m, npos))
        live = nlive & live
    return out[:, :E], count


def match_plain(buf: torch.Tensor, starts: np.ndarray, ends: np.ndarray):
    """Plain PyTorch version of :func:`lz4_match` (the prep through
    :func:`lz4_prep`, the rest :func:`match_rows_plain`): ``(pos, dist,
    mlen)`` int64 arrays sorted by position."""
    ev, count = match_rows_plain(buf, starts, ends)
    return compact_events(ev.cpu().numpy(), count.cpu().numpy(),
                          event_rows(starts, ends))


def match_chain_plain(buf: torch.Tensor, starts: np.ndarray,
                      ends: np.ndarray):
    """The match kernel's selection rule as PyTorch operations on ``buf``'s
    device (the tests hold it to :func:`match_plain` and the reference):
    ``(pos, dist, mlen)`` int64 arrays sorted by position.

    prev() and the candidate test as in :func:`match_rows_plain` (the prep
    through :func:`prep_plain`); then, as ``csrc/lz4_match.cu`` does:
    candidate ranks (the rank of the first candidate at or after a
    position is the count before it); reverse cumulative minima for the
    run ends and the same-distance chain ends; match lengths of chain
    ends measured (run end for distance 1, else a word gallop and a byte
    tail), inside a chain ``LCP(p) = (e - p) + LCP(e)``; each candidate's
    next candidate by rank, none past its stream; in chunks of 32 ranks,
    each candidate's exit from its chunk and the chain nodes up to it by
    pointer doubling; each stream's chain over the chunks (an entry in a
    chunk, its events before); and the nodes on the chain from each entry
    by pointer doubling, written to their rows as the kernel writes them.
    """
    N = int(buf.numel())
    dev = buf.device
    i64 = torch.int64
    S = int(starts.size)
    if N < MIN_MATCH or S == 0:
        return _EMPTY
    npos = N - 3
    sid, covered = _stream_ids(npos, starts, ends)
    sidc = np.minimum(sid, S - 1)
    valid = covered & (np.arange(npos) + MIN_MATCH <= ends[sidc])
    local = np.arange(npos) - starts[sidc]
    start_ok = valid & (local < (ends - starts)[sidc] - MFLIMIT)
    stride_ok = (local >= 2) & (local % RUN_STRIDE != 0)

    def up(a, dtype=i64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    valid_t, start_ok_t, stride_ok_t = (up(a, torch.bool)
                                        for a in (valid, start_ok, stride_ok))
    w, h, runb = prep_plain(buf)
    w, h = w[:npos].to(i64), h[:npos].to(i64)
    b = buf.to(i64)
    iota = torch.arange(npos, dtype=i64, device=dev)
    # prev(): the stable-sort neighbour of the stream-namespaced hash key
    BIG = (S + 1) * HASH_SIZE
    keys = torch.where(valid_t, up(sidc) * HASH_SIZE + h, BIG)
    sk, order = torch.sort(keys, stable=True)
    prev = torch.full((npos,), -1, dtype=i64, device=dev)
    prev[order[1:]] = torch.where((sk[1:] == sk[:-1]) & (sk[1:] < BIG),
                                  order[:-1], -1)
    dist = iota - prev
    pc = prev.clamp(min=0)
    bm = torch.cat([torch.zeros(2, dtype=i64, device=dev), b])
    ok = (start_ok_t & (prev >= 0) & (dist <= 0xFFFF) & (w == w[pc])
          & ~((dist == 1) & stride_ok_t & (bm[:npos] == bm[1 : npos + 1])))
    # ranks: cs[x] = candidates before x = the rank of the first at or
    # after x
    cs = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                    torch.cumsum(ok.to(i64), 0)])
    cpos = torch.nonzero(ok).flatten()
    C = int(cpos.numel())
    if C == 0:
        return _EMPTY
    d = dist[cpos]
    # reverse cumulative minima: the next run bit, the next chain end
    run_at = torch.where(runb[:npos] > 0, iota, npos)
    run_end = _rev_cummin(run_at)
    nxt_ok = torch.cat([ok[1:], torch.zeros(1, dtype=torch.bool,
                                            device=dev)])
    nxt_d = torch.cat([dist[1:], torch.zeros(1, dtype=i64, device=dev)])
    link = ok & nxt_ok & (nxt_d == dist) & (dist > 1)
    chain_end = _rev_cummin(torch.where(link, npos, iota))
    cap = up(ends)[up(sidc)[cpos]] - LAST_LITERALS - cpos
    m = torch.zeros(C, dtype=i64, device=dev)
    run = d == 1
    m[run] = torch.minimum(run_end[cpos[run]] - cpos[run] + 1, cap[run])
    end = ~run & ~link[cpos]
    p, c, cp = cpos[end], cpos[end] - d[end], cap[end]
    me = torch.full_like(p, MIN_MATCH)
    while True:     # word gallop while the words agree and fit
        adv = (me + 4 <= cp) & (w[(p + me).clamp(max=npos - 1)]
                                 == w[(c + me).clamp(max=npos - 1)])
        if not bool(adv.any()):
            break
        me = me + 4 * adv.to(i64)
    for _ in range(3):      # exact <= 3-byte tail
        me = me + ((me < cp) & (b[(p + me).clamp(max=N - 1)]
                                == b[(c + me).clamp(max=N - 1)])).to(i64)
    m[end] = me
    inner = link[cpos]
    e = chain_end[cpos[inner]]
    m[inner] = e - cpos[inner] + m[cs[e]]
    # next candidates by rank (C: none past the stream)
    re = cs[up(np.minimum(ends, npos))]
    rb = cs[up(np.minimum(starts, npos))]
    nxt = cs[cpos + m]
    J = torch.where(nxt < re[up(sidc)[cpos]], nxt, C)
    # chunks of 32 ranks: each candidate's exit from its chunk and the
    # chain nodes up to it, by pointer doubling (list ranking)
    rank = torch.arange(C, dtype=i64, device=dev)
    chunk = rank // 32
    inside = (J < C) & (J // 32 == chunk)
    succ = torch.where(inside, J, C)
    link, ex, cnt = succ.clone(), J.clone(), torch.ones(C, dtype=i64,
                                                       device=dev)
    for _ in range(5):
        has = link < C
        at = link.clamp(max=C - 1)
        cnt = torch.where(has, cnt + cnt[at], cnt)
        ex = torch.where(has, ex[at], ex)
        link = torch.where(has, link[at], link)
    # each stream's chain over the chunks: entries and events before
    entry = torch.zeros(C, dtype=torch.bool, device=dev)
    before = torch.zeros(C, dtype=i64, device=dev)
    count = np.zeros(S, dtype=np.int64)
    exits, cnts = ex.tolist(), cnt.tolist()
    for s, (b0, b1) in enumerate(zip(rb.tolist(), re.tolist())):
        e = b0 if b0 < b1 else C
        while e < C:
            entry[e] = True
            before[e] = int(count[s])
            count[s] += cnts[e]
            e = exits[e]
    # per chunk, the nodes on the chain from its entries by doubling
    on = entry.clone()
    step = succ.clone()
    for _ in range(5):
        hit = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        hit[step[on]] = True
        on |= hit[:C]
        step = torch.cat([step, step.new_full((1,), C)])[step]
    # rows: the entry at or before a node in its chunk (a stream's ranks
    # are contiguous), its events before, the nodes between
    last = torch.cummax(torch.where(entry, rank, -1), 0).values
    assert bool((last[on] >= 0).all() and (last[on] // 32 == chunk[on]).all())
    el = last.clamp(min=0)
    row = before[el] + cnt[el] - cnt
    rows = event_rows(starts, ends)
    sid_c = up(sidc)[cpos]
    out = torch.zeros((3, int(rows[-1])), dtype=i64, device=dev)
    at = up(rows[:-1])[sid_c[on]] + row[on]
    out[:, at] = torch.stack([cpos[on], d[on], m[on]])
    return compact_events(out.cpu().numpy(), count, rows)


def match_plan(starts, ends, addr: int, pack: int, tile_max: int,
               scratch_bytes, rows=None):
    """The match kernel's launch layout, on the host (numpy): ``(meta, B,
    tile, scratch)``.

    A stream's region starts on a 32-position word of its block and runs
    ``max(32, ceil32(off + L))`` positions, ``off`` its first byte's
    address (``addr + start``) mod 16, where its first byte lies.
    Consecutive streams of at most ``pack`` region bytes form a block
    while their regions start within one ``pack`` window; every longer
    stream is a block of its own, staged up to ``tile_max`` positions and
    past that in global scratch (``scratch_bytes(P)`` bytes for P
    positions, P its region rounded up to 512).  ``meta`` (int64): starts,
    ends, first event rows, scratch offsets (-1: staged), block-local first
    positions, then each block's first stream and S; ``tile`` the largest
    staged block's positions rounded up to 128; ``scratch`` the scratch
    bytes in all.  ``rows``: :func:`event_rows`, when the caller has them.
    """
    starts = np.asarray(starts, dtype=np.int64).ravel()
    ends = np.asarray(ends, dtype=np.int64).ravel()
    S = int(starts.size)
    if rows is None:
        rows = event_rows(starts, ends)
    off = (addr + starts) & 15
    rsz = np.maximum((off + ends - starts + 31) & ~31, 32)
    before = np.cumsum(rsz) - rsz
    small = rsz <= min(pack, tile_max // 2)
    sm = np.where(small, rsz, 0)
    window = (np.cumsum(sm) - sm) // pack
    new = np.ones(S, dtype=bool)
    new[1:] = ~small[1:] | ~small[:-1] | (window[1:] != window[:-1])
    first = np.flatnonzero(new)
    spans = np.add.reduceat(rsz, first) if S else rsz
    cst = before - before[first][np.cumsum(new) - 1] + off
    soff = np.full(S, -1, dtype=np.int64)
    nscr = 0
    long = rsz > tile_max
    if long.any():
        spans = spans[~long[first]]
        a0 = scratch_bytes(0)
        per = a0 + (scratch_bytes(512) - a0) * (-(-rsz[long] // 512))
        soff[long] = np.cumsum(per) - per
        nscr = int(per.sum())
    tile = int(-(-spans.max() // 128) * 128) if spans.size else 0
    meta = np.concatenate([starts, ends, rows[:-1], soff, cst, first, [S]])
    return meta, int(first.size), tile, nscr


def _lib_geometry(lib):
    """(pack, tile_max, scratch_bytes) of a match library, asked once."""
    geo = getattr(lib, "_match_geometry", None)
    if geo is None:
        sizes = {}

        def scratch_bytes(P: int) -> int:
            if P not in sizes:
                sizes[P] = int(lib.lz4_match_scratch_bytes(P))
            return sizes[P]

        geo = (int(lib.lz4_match_pack_bytes()),
               int(lib.lz4_match_tile_max()), scratch_bytes)
        lib._match_geometry = geo
    return geo


PLANS_KEPT = 256    # launch layouts a match library keeps (oldest goes)


def _plan_of(lib, buf: torch.Tensor, starts: np.ndarray, ends: np.ndarray):
    """``(meta, B, tile, scratch, rows)`` of a launch on checked bounds:
    :func:`match_plan`'s layout with its meta uploaded to the slab's
    device.  Kept on the library by the device, the slab's address mod 16
    and the bounds, since a flush or a weight's planes repeat them: a
    repeat neither lays out nor uploads again.  ``rows`` is read-only."""
    key = (buf.device, buf.data_ptr() & 15, starts.tobytes(), ends.tobytes())
    plans = getattr(lib, "_match_plans", None)
    if plans is None:
        plans = lib._match_plans = {}
    plan = plans.get(key)
    if plan is None:
        rows = event_rows(starts, ends)
        rows.setflags(write=False)
        meta, B, tile, nscr = match_plan(starts, ends, buf.data_ptr(),
                                         *_lib_geometry(lib), rows=rows)
        if len(plans) >= PLANS_KEPT:
            del plans[next(iter(plans))]
        plan = plans[key] = (torch.from_numpy(meta).to(buf.device), B, tile,
                             nscr, rows)
    return plan


def match_launch(buf: torch.Tensor, starts, ends, lib=None):
    """The match kernel's launch on a contiguous uint8 slab on the card,
    set up once: checks the stream bounds, lays the streams out into
    blocks (:func:`match_plan`) and uploads the meta, both kept for a
    repeat of the same bounds (:func:`_plan_of`), and allocates the output
    and the long streams' scratch (none when no stream needs it).  Returns
    ``(launch, out, rows)``: ``launch()`` runs the match kernel once on
    PyTorch's current stream and raises if it fails (it counts nothing:
    :func:`lz4_match` does), ``out`` its ``S + 3 E`` int32 output (counts
    | pos | dist | mlen, read by :func:`match_result`), ``rows`` the
    streams' event rows (:func:`event_rows`, read-only).  ``launch`` is
    None when no stream has a byte to match.  ``lib`` is the built library
    (default: ``csrc/lz4_match.cu``'s)."""
    starts = np.asarray(starts, dtype=np.int64).ravel()
    ends = np.asarray(ends, dtype=np.int64).ravel()
    if not buf.is_contiguous():
        raise ValueError("match kernel needs a contiguous slab")
    N = buf.numel()
    sizes = ends - starts
    if starts.size != ends.size or (sizes < 0).any() or (
            starts.size and (starts[0] < 0 or ends[-1] > N
                             or (starts[1:] < ends[:-1]).any())):
        raise ValueError("stream bounds must be ascending, disjoint and "
                         "inside the slab")
    if N >= 1 << 31:
        raise ValueError(f"slab of {N} bytes: positions are int32")
    S = int(starts.size)
    if S == 0 or N < MIN_MATCH:
        return None, None, event_rows(starts, ends)
    lib = build.load("lz4_match") if lib is None else lib
    meta, B, tile, nscr, rows = _plan_of(lib, buf, starts, ends)
    E = int(rows[-1])
    dev = buf.device
    scratch = (torch.empty(nscr, dtype=torch.uint8, device=dev) if nscr
               else None)
    out = torch.empty(S + 3 * E, dtype=torch.int32, device=dev)

    def launch():
        build.check(lib.lz4_match(
            buf.data_ptr(), meta.data_ptr(), S, B, tile,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            E, dev.index, torch.cuda.current_stream(dev).cuda_stream),
            "lz4_match")

    return launch, out, rows


def match_result(out: torch.Tensor, rows: np.ndarray):
    """The match kernel's output (:func:`match_launch`) copied back once,
    into pinned memory: ``(pos, dist, mlen)`` int64 arrays sorted by
    position."""
    S, E = rows.size - 1, int(rows[-1])
    host = out
    if out.device.type == "cuda":
        with spans.span("tier.wait", nbytes=out.numel() * 4):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(out.device).synchronize()
    host = host.numpy()
    return compact_events(host[S:].reshape(3, E), host[:S], rows)


def lz4_match(buf: torch.Tensor, starts, ends):
    """Greedy match events of every stream of a flat uint8 slab on its
    device: on the card one launch of the match kernel (from the bytes)
    and one copy of the events back; on the CPU :func:`match_plain`.
    Returns ``(pos, dist, mlen)`` int64 arrays sorted by position."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"match expects a flat uint8 slab, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    if buf.device.type == "cpu":
        return match_plain(buf, np.asarray(starts, dtype=np.int64).ravel(),
                           np.asarray(ends, dtype=np.int64).ravel())
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    launch, out, rows = match_launch(buf, starts, ends)
    if launch is None:
        return _EMPTY
    launch()
    build.LAUNCHES["lz4_match"] += 1
    return match_result(out, rows)
