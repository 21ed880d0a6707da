"""Commodity lossless codecs used by the device model (paper §III-B).

TRACE deliberately reuses *generic* codecs — the gain comes from changing
the codec input (plane streams instead of mixed-field words), not from a
bespoke compressor.  The paper's two codecs:

* ``lz4`` — a from-scratch LZ4 *block format* encoder/decoder.  Greedy
  hash-chain matching, standard end-of-block rules, byte-exact round-trip;
  it stands in for the 32-lane streaming LZ4 engine of the controller
  (paper §IV-E).  On the write path the match search runs on the slab's
  device (``kernels.lz4``: one match kernel launch from the slab's bytes
  on the card) and only the byte-level emit runs on the host.
* ``zstd`` — the real Zstandard via the optional ``zstandard`` package.

Both are exposed through a tiny registry with block-level *bypass*: when a
block is incompressible the device stores it raw and marks the index entry
(paper §III-D "Bypass and correctness invariants").  The bypass decision is
two-stage: a cheap sampled entropy pre-screen routes near-certainly
incompressible blocks to raw storage *before* paying for compression (the
controller's line-rate engines do the same to avoid stalling on
high-entropy planes), and blocks that do run the codec fall back to raw
when the payload fails :data:`BYPASS_THRESHOLD`.

The write path is batched: :func:`compress_slab` / :func:`compress_batch`
compress a flush group's streams in one pass (one match search over the
concatenated slab, one vectorized emit; zstd through the library's
multi-frame API when available), byte-identical per stream to
:func:`lz4_compress` — per-stream hash tables, per-stream emit.

Contract: every compressed payload round-trips byte-exactly through
:func:`decompress_batch`; a ``RAW`` flag always means the stored payload
IS the input bytes.  The layout strategies in ``core.tier`` rely on both.
"""

from __future__ import annotations

import os
import warnings
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import spans
from ..kernels import lz4 as klz4

try:
    import zstandard as _zstd

    _ZSTD_C = _zstd.ZstdCompressor(level=3)
    _ZSTD_D = _zstd.ZstdDecompressor()
except (ImportError, AttributeError):  # pragma: no cover - optional dep
    _zstd = None

HAVE_ZSTD = _zstd is not None

# The scalar reference and the match pipeline share one set of policy
# constants (defined in kernels.lz4), so they cannot drift apart.
_HASH_LOG = klz4.HASH_LOG
_HASH_SIZE = klz4.HASH_SIZE
_MIN_MATCH = klz4.MIN_MATCH
_MFLIMIT = klz4.MFLIMIT
_LAST_LITERALS = klz4.LAST_LITERALS


class CorruptPayloadError(ValueError):
    """A compressed payload failed structural validation during decode.

    Raised by :func:`lz4_decompress` for truncated frames, match offsets
    pointing before the produced-length frontier, zero offsets, and
    outputs exceeding the caller's bound — instead of surfacing a raw
    ``IndexError`` or silently wrapping a bad copy.  Subclasses
    ``ValueError`` so existing callers that guard broadly keep working.
    """


# ---------------------------------------------------------------------------
# LZ4 block format
# ---------------------------------------------------------------------------

def _lz4_words_hashes(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised 4-byte little-endian words + hashes for every position.

    ``buf`` may be a whole encode slab: per-block hash/emit loops only ever
    touch positions whose 4-byte window lies inside their own block, so the
    precompute can be shared across a batch (see :func:`lz4_compress_batch`).
    """
    w = (
        buf[:-3].astype(np.uint32)
        | (buf[1:-2].astype(np.uint32) << 8)
        | (buf[2:-1].astype(np.uint32) << 16)
        | (buf[3:].astype(np.uint32) << 24)
    )
    hashes = ((w * np.uint32(2654435761)) >> np.uint32(32 - _HASH_LOG)).astype(
        np.int64
    )
    return w, hashes


_MATCH_CAP = 64        # vectorized-LCP sweep bound for offsets > 1; NOT an
                       # output cap — selected matches that reach it are
                       # extended to the true LCP by galloping (offset-1
                       # byte runs extend uncapped via the run table), so
                       # emitted matches equal the scalar scan's exactly
_RUN_STRIDE = klz4.RUN_STRIDE  # interior byte-run positions keep a
                               # candidate only every _RUN_STRIDE bytes


def _emit_seq(out: bytearray, data: bytes, lit_start: int, lit_end: int,
              mlen: int, dist: int):
    """Append one LZ4 sequence (token, literal run, optional match) —
    the general path with 255-extension chains; ``mlen == 0`` emits the
    end-of-block literal-only sequence."""
    append = out.append
    lit_len = lit_end - lit_start
    tok_lit = min(lit_len, 15)
    tok_match = min(mlen - _MIN_MATCH, 15) if mlen else 0
    append((tok_lit << 4) | tok_match)
    rest = lit_len - 15
    while rest >= 0:
        append(min(rest, 255))
        if rest < 255:
            break
        rest -= 255
    out += data[lit_start:lit_end]
    if mlen:
        append(dist & 0xFF)
        append(dist >> 8)
        rest = mlen - _MIN_MATCH - 15
        while rest >= 0:
            append(min(rest, 255))
            if rest < 255:
                break
            rest -= 255


def _lz4_emit(data: bytes, events, out: bytearray):
    """Serialize match ``events`` over ``data`` in LZ4 block format.

    ``events`` is an ascending list of ``(pos, dist, mlen)``; everything
    between events is literals, and the block ends in a literal-only
    sequence (the standard end-of-block rule).
    """
    n = len(data)
    anchor = 0
    for pos, dist, mlen in events:
        _emit_seq(out, data, anchor, pos, mlen, dist)
        anchor = pos + mlen
    _emit_seq(out, data, anchor, n, 0, 0)


def _lz4_events_scalar(data: bytes) -> list:
    """Reference match scan for one block — sequential python.

    The algorithm (shared bit-for-bit with the vectorized batch scan):
    every position feeds a last-occurrence hash table; a position ``i``
    outside any selected match starts a match when its table candidate
    has the same 4-byte word within the 64 KiB window; matches extend by
    LCP, bounded by the end-of-block literal rules.  Offset-1
    candidates are honoured only at a run's FIRST interior position
    (``data[i-2] != data[i-1]``): one uncapped match covers the whole
    run, and skipping the interior keeps the batch scan's candidate set
    proportional to runs, not bytes.
    """
    n = len(data)
    events: list = []
    if n < _MFLIMIT + 1:
        return events
    w_np, h_np = _lz4_words_hashes(np.frombuffer(data, dtype=np.uint8))
    w, hashes = w_np.tolist(), h_np.tolist()
    table = [-1] * _HASH_SIZE
    limit = n - _MFLIMIT
    cur_end = 0
    for i in range(n - 3):
        h = hashes[i]
        cand = table[h]
        table[h] = i
        if (i >= limit or i < cur_end or cand < 0
                or i - cand > 0xFFFF or w[cand] != w[i]):
            continue
        dist = i - cand
        if (dist == 1 and i >= 2 and data[i - 2] == data[i - 1]
                and i % _RUN_STRIDE):
            continue          # run interior: covered by run-first / stride
        max_len = n - _LAST_LITERALS - i
        mlen = _MIN_MATCH
        while (mlen + 32 <= max_len
               and data[cand + mlen : cand + mlen + 32]
               == data[i + mlen : i + mlen + 32]):
            mlen += 32
        while mlen < max_len and data[cand + mlen] == data[i + mlen]:
            mlen += 1
        events.append((i, dist, mlen))
        cur_end = i + mlen
    return events


def lz4_compress(data: bytes) -> bytes:
    """LZ4 block-format compression (pure python + numpy hashing)."""
    if len(data) == 0:
        return b"\x00"
    out = bytearray()
    _lz4_emit(data, _lz4_events_scalar(data), out)
    return bytes(out)


def _lz4_compress_slab(buf: np.ndarray, chunks: Sequence[bytes]) -> List[bytes]:
    """Vectorized match scan + fused greedy emit over a concatenated slab.

    One word/hash pass, one previous-occurrence argsort, one run-boundary
    scan and one (capped) LCP sweep serve every block of the batch; only
    the final greedy selection walks SELECTED matches in python, emitting
    each sequence as it is chosen (no event materialization).  Per block
    the output is byte-identical to :func:`lz4_compress`: the
    previous-occurrence keys are namespaced by block id, so candidates can
    never cross a block boundary, exactly like the per-block hash table.
    """
    N = int(buf.size)
    B = len(chunks)
    def _all_literals() -> List[bytes]:
        outs = []
        for data in chunks:
            blk = bytearray()
            _lz4_emit(data, [], blk)
            outs.append(bytes(blk) if data else b"\x00")
        return outs
    if N < _MIN_MATCH:
        return _all_literals()
    w, h = _lz4_words_hashes(buf)
    sizes_a = np.asarray([len(c) for c in chunks], dtype=np.int64)
    ends = np.cumsum(sizes_a)
    starts_a = ends - sizes_a
    # positions whose 4-byte word lies inside their own block: everything
    # except the (up to) 3 positions before each block boundary
    mask = np.ones(N - 3, dtype=bool)
    cols = (ends[:, None] - np.arange(3, 0, -1)[None, :]).ravel()
    cols = cols[(cols >= np.repeat(starts_a, 3)) & (cols >= 0)
                & (cols < N - 3)]
    mask[cols] = False
    wvalid = np.flatnonzero(mask)
    if wvalid.size == 0:
        return _all_literals()
    # previous same-hash occurrence within the block = last-occurrence
    # hash table, computed for all positions at once (int32 keys sort
    # measurably faster and hold block_id * 8192 + hash comfortably)
    blk_w = np.searchsorted(ends, wvalid, side="right")
    keys = (blk_w * np.int64(_HASH_SIZE) + h[wvalid]).astype(
        np.int32 if B * _HASH_SIZE < (1 << 31) else np.int64
    )
    order = np.argsort(keys, kind="stable")      # stable: ascending pos
    sp = wvalid[order]
    same = keys[order][1:] == keys[order][:-1]
    prev = np.full(N - 3, -1, dtype=np.int64)
    prev[sp[1:][same]] = sp[:-1][same]

    g = np.flatnonzero(prev >= 0)
    cand = prev[g]
    blk_g = np.searchsorted(ends, g, side="right")
    local_g = g - starts_a[blk_g]
    nb_g = sizes_a[blk_g]
    ok = ((local_g < nb_g - _MFLIMIT)
          & (g - cand <= 0xFFFF)
          & (w[g] == w[cand]))
    # interior of a byte run: covered by the run-first candidate's
    # uncapped match (same rule as the scalar scan) — dropping all but
    # every _RUN_STRIDE-th keeps the candidate set ~N/4 instead of N on
    # zero-heavy planes, while matches that end mid-run re-anchor within
    # at most _RUN_STRIDE-1 literal bytes
    ok &= ~((g - cand == 1) & (local_g >= 2) & (buf[g - 2] == buf[g - 1])
            & (local_g % _RUN_STRIDE != 0))
    keep = np.flatnonzero(ok)
    g, cand, blk_g, local_g, nb_g = (
        g[keep], cand[keep], blk_g[keep], local_g[keep], nb_g[keep])
    if g.size == 0:
        return _all_literals()
    dist = g - cand
    max_len = nb_g - _LAST_LITERALS - local_g
    mlen = np.full(g.size, _MIN_MATCH, dtype=np.int64)

    run = dist == 1
    if run.any():
        # offset-1 = byte run: LCP is the run length, read off the
        # run-boundary table instead of byte-compare loops
        bnd = np.flatnonzero(buf[1:] != buf[:-1])    # last index of each run
        if bnd.size:
            idx = np.searchsorted(bnd, g[run] - 1, side="left")
            rend = np.where(idx < bnd.size,
                            bnd[np.minimum(idx, bnd.size - 1)], N - 1)
        else:
            rend = np.full(int(run.sum()), N - 1, dtype=np.int64)
        mlen[run] = np.minimum(rend - g[run] + 1, max_len[run])
    gen = np.flatnonzero(~run)
    if gen.size:
        # LCP sweep, word-stride: compare 4 bytes per pass via the word
        # array (w[x] = bytes x..x+3, in-block by the cap bound); a failed
        # word resolves its 0-3 leading equal bytes exactly, survivors
        # that run out of word room finish in the byte phase below.
        cap = np.minimum(max_len[gen], _MATCH_CAP)
        gg, cc = g[gen], cand[gen]
        ml = np.full(gen.size, _MIN_MATCH, dtype=np.int64)
        k = _MIN_MATCH
        alive = np.arange(gen.size)
        partial: List[np.ndarray] = []       # ran out of word room at ml=k
        while True:
            word_ok = cap[alive] >= k + 4
            if not word_ok.all():
                partial.append(alive[~word_ok])
                alive = alive[word_ok]
            if alive.size == 0:
                break
            eqw = w[gg[alive] + k] == w[cc[alive] + k]
            fail = alive[~eqw]
            if fail.size:
                b0 = (buf[gg[fail] + k] == buf[cc[fail] + k]).astype(np.int64)
                b1 = b0 & (buf[gg[fail] + k + 1] == buf[cc[fail] + k + 1])
                b2 = b1 & (buf[gg[fail] + k + 2] == buf[cc[fail] + k + 2])
                ml[fail] = k + b0 + b1 + b2
            alive = alive[eqw]
            k += 4
            ml[alive] = k
        # byte phase: at most 3 bytes of per-element room left
        arr = np.concatenate(partial) if partial else alive
        while arr.size:
            arr = arr[cap[arr] > ml[arr]]
            if arr.size == 0:
                break
            eq = buf[gg[arr] + ml[arr]] == buf[cc[arr] + ml[arr]]
            arr = arr[eq]
            ml[arr] += 1
        mlen[gen] = ml

    # Greedy left-to-right selection fused with emit.  bisect skips the
    # candidates a selected match covers in O(log) instead of walking
    # them, so this loop runs once per EMITTED match, not once per
    # candidate; dist/mlen are only materialized for matches that are
    # actually selected, and each sequence is serialized as it is chosen.
    # Selected matches whose sweep hit _MATCH_CAP gallop out to the true
    # LCP here — selected matches never overlap, so total galloping work
    # is bounded by the slab size.
    pos_l = local_g.tolist()
    b_lo = np.searchsorted(blk_g, np.arange(B), side="left").tolist()
    b_hi = np.searchsorted(blk_g, np.arange(B), side="right").tolist()
    dist_i = dist.item
    mlen_i = mlen.item
    sizes_l = sizes_a.tolist()
    outs: List[bytes] = []
    for blk in range(B):
        data = chunks[blk]
        n = sizes_l[blk]
        if n == 0:
            outs.append(b"\x00")
            continue
        i, hi = b_lo[blk], b_hi[blk]
        out = bytearray()
        append = out.append
        anchor = 0
        while i < hi:
            p = pos_l[i]
            m = mlen_i(i)
            d = dist_i(i)
            if m == _MATCH_CAP and d != 1:
                c = p - d
                max_len = n - _LAST_LITERALS - p
                while (m + 32 <= max_len
                       and data[c + m : c + m + 32]
                       == data[p + m : p + m + 32]):
                    m += 32
                while m < max_len and data[c + m] == data[p + m]:
                    m += 1
            lit = p - anchor
            if lit < 15 and m < 19:
                # fast path: single token byte, no extension chains
                append((lit << 4) | (m - _MIN_MATCH))
                out += data[anchor:p]
                append(d & 0xFF)
                append(d >> 8)
            else:
                _emit_seq(out, data, anchor, p, m, d)
            anchor = p + m
            i = bisect_left(pos_l, anchor, i + 1, hi)
        lit = n - anchor
        if lit < 15:
            append(lit << 4)
            out += data[anchor:]
        else:
            _emit_seq(out, data, anchor, n, 0, 0)
        outs.append(bytes(out))
    return outs


def _scalar_lz4_forced() -> bool:
    """``TRACE_SCALAR_LZ4=1`` pins the fused slab encoder
    (:func:`_lz4_compress_slab`) — the parity oracle the match pipeline
    is differential-tested against."""
    return os.environ.get("TRACE_SCALAR_LZ4", "") not in ("", "0")


def lz4_emit_events(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                    pos: np.ndarray, dist: np.ndarray,
                    mlen: np.ndarray) -> List[bytes]:
    """Serialize a match event tensor to LZ4 block payloads — vectorized.

    The event tensor is the kernel/emit interface: three int64 arrays
    sorted by global ``pos`` (match start), ``dist`` (backwards offset,
    1..65535) and ``mlen`` (true LCP length ≥ 4), one row per selected
    match across ALL streams of the slab; stream membership is implied
    by position.  Gaps between events are literal runs; each stream ends
    in a literal-only closer sequence (the standard end-of-block rule).

    Instead of walking sequences in python, the serializer builds a
    per-sequence table (token value, extension-chain lengths, literal
    source/length, output offset via one cumsum) and scatters token
    bytes, 255-extension chains, literals and offset words with ragged
    numpy fills — O(output bytes) C-speed work, no per-match python.
    Byte-identical to :func:`_lz4_emit` over each stream's events.
    """
    S = int(starts.size)
    E = int(pos.size)
    sizes = ends - starts
    sid_e = np.searchsorted(ends, pos, side="right")
    ec = np.bincount(sid_e, minlength=S) if E else np.zeros(S, np.int64)
    ecum = np.concatenate(([0], np.cumsum(ec)))
    mend = pos + mlen
    # literal anchors: stream start for a stream's first event, previous
    # match end for the rest; closer rows start at the last match end
    first = np.ones(E, dtype=bool)
    first[1:] = sid_e[1:] != sid_e[:-1]
    anchor = np.empty(E, dtype=np.int64)
    anchor[first] = starts[sid_e[first]]
    anchor[~first] = mend[:-1][~first[1:]]
    fin_anchor = starts.copy()
    nz = ec > 0
    fin_anchor[nz] = mend[ecum[1:][nz] - 1]

    # sequence table: per stream, ec rows then one literal-only closer
    row_start = np.concatenate(([0], np.cumsum(ec + 1)))
    R = int(row_start[-1])
    ev_rows = row_start[sid_e] + (np.arange(E) - ecum[sid_e])
    fin_rows = row_start[:-1] + ec
    lit = np.empty(R, dtype=np.int64)
    lsrc = np.empty(R, dtype=np.int64)
    mr = np.zeros(R, dtype=np.int64)
    dr = np.zeros(R, dtype=np.int64)
    lit[ev_rows] = pos - anchor
    lsrc[ev_rows] = anchor
    mr[ev_rows] = mlen
    dr[ev_rows] = dist
    lit[fin_rows] = ends - fin_anchor
    lsrc[fin_rows] = fin_anchor

    has_m = mr > 0
    lit_ext = np.where(lit >= 15, (lit - 15) // 255 + 1, 0)
    mx = np.where(has_m, mr - _MIN_MATCH, 0)
    m_ext = np.where(mx >= 15, (mx - 15) // 255 + 1, 0)
    row_len = 1 + lit_ext + lit + 2 * has_m + m_ext
    out_off = np.concatenate(([0], np.cumsum(row_len)))
    out = np.empty(int(out_off[-1]), dtype=np.uint8)

    tok = (np.minimum(lit, 15) << 4) | np.minimum(mx, 15)
    out[out_off[:-1]] = tok.astype(np.uint8)

    def _ext_chain(rows: np.ndarray, base: np.ndarray, val: np.ndarray,
                   cnt: np.ndarray) -> None:
        # 255-extension chain: cnt bytes of 255...255, rem — rem < 255 by
        # construction of cnt = (val - 15) // 255 + 1
        tot = int(cnt.sum())
        gend = np.cumsum(cnt)
        within = np.arange(tot) - np.repeat(gend - cnt, cnt)
        vals = np.full(tot, 255, dtype=np.uint8)
        vals[gend - 1] = (val - 15 - 255 * (cnt - 1)).astype(np.uint8)
        out[np.repeat(base, cnt) + within] = vals

    er = np.flatnonzero(lit_ext > 0)
    if er.size:
        _ext_chain(er, out_off[:-1][er] + 1, lit[er], lit_ext[er])
    lstart = out_off[:-1] + 1 + lit_ext
    lr = np.flatnonzero(lit > 0)
    if lr.size:
        # int32 ragged indices: the literal copy touches ~every output
        # byte, so halving index-array traffic is a measurable win
        cnt = lit[lr]
        within = np.arange(int(cnt.sum()), dtype=np.int32)
        within -= np.repeat((np.cumsum(cnt) - cnt).astype(np.int32), cnt)
        dsti = np.repeat(lstart[lr].astype(np.int32), cnt)
        dsti += within
        srci = np.repeat(lsrc[lr].astype(np.int32), cnt)
        srci += within
        out[dsti] = buf[srci]
    mstart = lstart + lit
    mrows = np.flatnonzero(has_m)
    if mrows.size:
        out[mstart[mrows]] = (dr[mrows] & 0xFF).astype(np.uint8)
        out[mstart[mrows] + 1] = (dr[mrows] >> 8).astype(np.uint8)
    xr = np.flatnonzero(m_ext > 0)
    if xr.size:
        _ext_chain(xr, mstart[xr] + 2, mx[xr], m_ext[xr])

    blob = out.tobytes()
    so = out_off[row_start]
    return [blob[so[s]: so[s + 1]] for s in range(S)]


def _lz4_slab_streams(slab, buf: np.ndarray, starts: np.ndarray,
                      ends: np.ndarray,
                      force: Optional[str] = None) -> List[bytes]:
    """LZ4-compress the addressed streams of a slab through the match
    pipeline (``kernels.lz4``) and the vectorized emit.

    ``slab`` may be a tensor on the card (handed straight to the match
    pipeline — no host round trip); ``buf`` is its host uint8 view for
    the emit.  ``TRACE_SCALAR_LZ4=1`` pins the fused slab oracle instead.
    """
    if _scalar_lz4_forced():
        chunks = [buf[s:e].tobytes() for s, e in zip(starts, ends)]
        return _lz4_compress_slab(
            np.frombuffer(b"".join(chunks), dtype=np.uint8), chunks)
    starts = np.asarray(starts, dtype=np.int64).ravel()
    ends = np.asarray(ends, dtype=np.int64).ravel()
    gapped = bool(starts.size) and (
        int(starts[0]) != 0 or int(ends[-1]) != buf.size
        or bool((starts[1:] != ends[:-1]).any()))
    on_card = isinstance(slab, torch.Tensor) and slab.device.type == "cuda"
    if gapped and not on_card:
        # bypassed streams leave gaps in the slab, and the match passes
        # scale with every slab byte — compact a host slab down to the
        # covered ranges (a slab on the card stays put: a copy there
        # would cost the round trip this path avoids)
        sizes = ends - starts
        buf = np.concatenate([buf[a:b] for a, b in zip(starts, ends)])
        ends = np.cumsum(sizes)
        starts = ends - sizes
        slab = buf
    with spans.span("tier.match"):
        pos, dist, mlen = klz4.match_events_slab(slab, starts, ends,
                                                 force=force)
    with spans.span("tier.emit") as sp:
        out = lz4_emit_events(buf, starts, ends, pos, dist, mlen)
        if sp:
            sp.nbytes = sum(map(len, out))
    return out


def lz4_compress_batch(chunks: Sequence[bytes],
                       force: Optional[str] = None) -> List[bytes]:
    """Compress a batch of blocks in a few vectorized passes.

    Byte-identical to mapping :func:`lz4_compress` over ``chunks`` (the
    differential tests assert this).  The match scan runs as one array
    program over the concatenated slab (``kernels.lz4``: host bytes take
    the numpy twin unless ``force="device"``) and the token emit is one
    ragged scatter (:func:`lz4_emit_events`); ``TRACE_SCALAR_LZ4=1`` pins
    the fused slab encoder as a parity oracle.
    """
    if not chunks:
        return []
    sizes = np.asarray([len(c) for c in chunks], dtype=np.int64)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    buf = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    return _lz4_slab_streams(buf, buf, starts, ends, force=force)


def lz4_decompress(comp: bytes, max_out: int | None = None) -> bytes:
    """Decode an LZ4 block payload, validating structure as it goes.

    Corrupt frames — truncated extension chains or literal runs, a match
    offset of zero or pointing before the produced-length frontier, or
    output exceeding ``max_out`` — raise :class:`CorruptPayloadError`
    rather than an ``IndexError`` or a silently-wrapped copy.
    """
    out = bytearray()
    i, n = 0, len(comp)
    while i < n:
        token = comp[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise CorruptPayloadError(
                        "lz4: truncated literal-length extension at byte "
                        f"{i} of {n}")
                b = comp[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise CorruptPayloadError(
                f"lz4: literal run of {lit_len} overruns frame "
                f"({n - i} bytes left)")
        out.extend(comp[i : i + lit_len])
        i += lit_len
        if max_out is not None and len(out) > max_out:
            # checked before the last-sequence break: a tail literal run
            # must not overshoot the caller's bound either
            raise CorruptPayloadError(
                f"lz4: decompressed size {len(out)} exceeds bound {max_out}")
        if i >= n:
            break  # last sequence has no match part
        if i + 2 > n:
            raise CorruptPayloadError(
                f"lz4: truncated match offset at byte {i} of {n}")
        offset = comp[i] | (comp[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise CorruptPayloadError(
                f"lz4: match offset {offset} outside produced frontier "
                f"({len(out)} bytes)")
        mlen = (token & 0xF) + _MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise CorruptPayloadError(
                        "lz4: truncated match-length extension at byte "
                        f"{i} of {n}")
                b = comp[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if offset >= mlen:
            # disjoint source range — one slice copy
            out += out[start : start + mlen]
        else:
            # overlapping match = repeating pattern of period `offset`
            # (offset 1 is a byte run — the common case on zero-heavy
            # planes); replicate at C speed instead of a python loop
            pattern = bytes(out[start:])
            out += (pattern * (mlen // offset + 1))[:mlen]
        if max_out is not None and len(out) > max_out:
            raise CorruptPayloadError(
                f"lz4: decompressed size {len(out)} exceeds bound {max_out}")
    return bytes(out)


# ---------------------------------------------------------------------------
# zstd wrappers
# ---------------------------------------------------------------------------

def zstd_compress(data: bytes) -> bytes:
    if _zstd is None:  # pragma: no cover
        raise RuntimeError("zstandard not available")
    return _ZSTD_C.compress(data)


def zstd_compress_batch(chunks: Sequence[bytes]) -> List[bytes]:
    """Multi-frame zstd: one library call for a whole flush group.

    ``multi_compress_to_buffer`` produces the same independent frames as
    per-chunk :func:`zstd_compress` calls (same compressor parameters),
    amortizing python→C transitions; falls back to the per-chunk loop on
    older ``zstandard`` builds.
    """
    if _zstd is None:  # pragma: no cover
        raise RuntimeError("zstandard not available")
    if chunks and hasattr(_ZSTD_C, "multi_compress_to_buffer"):
        try:
            res = _ZSTD_C.multi_compress_to_buffer(list(chunks))
            return [res[i].tobytes() for i in range(len(res))]
        # tracecheck: allow-broad-except(multi_compress raises build-specific types; falls back to the byte-identical per-chunk loop)
        except Exception:  # pragma: no cover - library/build specific
            pass
    return [_ZSTD_C.compress(c) for c in chunks]


def zstd_decompress(data: bytes, max_out: int | None = None) -> bytes:
    if _zstd is None:  # pragma: no cover
        raise RuntimeError("zstandard not available")
    return _ZSTD_D.decompress(data, max_output_size=max_out or 0)


# ---------------------------------------------------------------------------
# Registry + block API with bypass
# ---------------------------------------------------------------------------

CODECS: Dict[str, Tuple[Callable[[bytes], bytes], Callable[..., bytes]]] = {
    "lz4": (lz4_compress, lz4_decompress),
    "none": (lambda b: b, lambda b, max_out=None: b),
}
if HAVE_ZSTD:
    CODECS["zstd"] = (zstd_compress, zstd_decompress)

_warned_fallback = False


def resolve_codec(name: str) -> str:
    """Map a requested codec to an available one.

    ``zstd`` silently degrades to ``lz4`` (with a one-time warning) when the
    ``zstandard`` package is missing, so device models stay usable in minimal
    environments; tests that depend on zstd-specific ratios should check
    :data:`HAVE_ZSTD` and skip instead.
    """
    global _warned_fallback
    if name in CODECS:
        return name
    if name == "zstd":
        if not _warned_fallback:
            warnings.warn(
                "zstandard is not installed; falling back to the built-in "
                "lz4 codec for all 'zstd' devices",
                RuntimeWarning,
                stacklevel=2,
            )
            _warned_fallback = True
        return "lz4"
    raise KeyError(f"unknown codec {name!r}; registered: {sorted(CODECS)}")

RAW, COMPRESSED = 0, 1

# Bypass rule (paper §III-D): a compressed payload is stored only when
# len(comp) < BYPASS_THRESHOLD * len(raw); otherwise the block is stored
# raw and the index entry is flagged.  1.0 = "store compressed iff it is
# strictly smaller" — the conservative setting that can never expand a
# block.  Devices that want headroom for decompression latency can lower
# it (e.g. 0.9 requires a 10% gain before paying the codec on reads).
BYPASS_THRESHOLD = 1.0

# Entropy pre-screen: blocks whose sampled byte distribution is this close
# to uniform (bits/byte, Miller-Madow bias-corrected) AND show no repeated
# 4-byte word among the sampled positions are routed to bypass WITHOUT
# running the codec.  Calibrated so uniform-random payloads ≥ 128 B (e.g.
# mantissa/sign plane streams of well-scaled bf16 tensors, H ≈ 7.6-8.0)
# bypass, while everything LZ4/zstd actually shrinks — periodic patterns,
# text, exponent planes — stays well below (H ≤ 6.8 or duplicate words).
BYPASS_ENTROPY_BITS = 7.5
_PRESCREEN_MIN_LEN = 128     # below this, codec overhead is negligible
_PRESCREEN_BYTES = 1024      # max bytes sampled for the histogram
_PRESCREEN_WORDS = 64        # 4-byte words sampled for the repeat check


def _prescreen_group(rows: np.ndarray) -> np.ndarray:
    """Vectorized pre-screen over a ``(R, n)`` uint8 matrix of same-length
    blocks → boolean bypass decision per row.

    Single source of truth: the scalar :func:`prescreen_bypass` wraps this
    with ``R = 1``, so the scalar and batched encoders cannot diverge on a
    threshold-boundary rounding difference.
    """
    R, n = rows.shape
    sample = rows[:, :: max(1, n // _PRESCREEN_BYTES)][:, :_PRESCREEN_BYTES]
    S = sample.shape[1]
    # per-row histograms via one offset bincount
    offs = (np.arange(R, dtype=np.int64) * 256)[:, None]
    counts = np.bincount(
        (sample.astype(np.int64) + offs).ravel(), minlength=256 * R
    ).reshape(R, 256)
    p = counts / S
    with np.errstate(divide="ignore", invalid="ignore"):
        plogp = np.where(counts > 0, p * np.log2(np.where(counts > 0, p, 1.0)),
                         0.0)
    # Miller-Madow correction removes the small-sample bias that would
    # otherwise make uniform data look ~0.3-0.7 bits "compressible".
    entropy = -plogp.sum(axis=1) \
        + ((counts > 0).sum(axis=1) - 1) / (2 * S * np.log(2))
    out = entropy >= BYPASS_ENTROPY_BITS
    if out.any():
        # Long-range repeats hide from a histogram: sample 4-byte words on
        # an even stride; any duplicate means LZ matches are likely —
        # compress instead of bypassing.
        k = min(_PRESCREEN_WORDS, n // 4)
        pos = np.arange(k, dtype=np.int64) * ((n - 4) // max(k - 1, 1))
        words = (
            rows[:, pos].astype(np.uint32)
            | (rows[:, pos + 1].astype(np.uint32) << 8)
            | (rows[:, pos + 2].astype(np.uint32) << 16)
            | (rows[:, pos + 3].astype(np.uint32) << 24)
        )
        sw = np.sort(words, axis=1)
        out &= ~(sw[:, 1:] == sw[:, :-1]).any(axis=1)
    return out


def prescreen_bypass(data: bytes) -> bool:
    """True when ``data`` is near-certainly incompressible (sampled test).

    Deterministic (stride sampling, no RNG) so scalar and batched encoders
    agree block-for-block.  False negatives only cost a wasted compression
    attempt; false positives would change stored bytes, so both statistics
    are thresholded conservatively.
    """
    if len(data) < _PRESCREEN_MIN_LEN:
        return False
    return bool(_prescreen_group(
        np.frombuffer(data, dtype=np.uint8).reshape(1, -1))[0])


def _prescreen_batch(chunks: Sequence[bytes]) -> List[bool]:
    """Per-block bypass decisions for a batch — identical to mapping
    :func:`prescreen_bypass`, but same-length blocks (the common case: a
    plane stream per 4 KB block) share one vectorized pass."""
    res = [False] * len(chunks)
    by_len: Dict[int, List[int]] = {}
    for i, ch in enumerate(chunks):
        if len(ch) >= _PRESCREEN_MIN_LEN:
            by_len.setdefault(len(ch), []).append(i)
    for n, idxs in by_len.items():
        rows = np.frombuffer(
            b"".join(chunks[i] for i in idxs), dtype=np.uint8
        ).reshape(len(idxs), n)
        for i, ok in zip(idxs, _prescreen_group(rows)):
            res[i] = bool(ok)
    return res


def _prescreen_slab(buf: np.ndarray, starts: np.ndarray,
                    ends: np.ndarray) -> np.ndarray:
    """:func:`_prescreen_batch` over slab-addressed streams — same-length
    streams gather into one ``(R, n)`` matrix, no bytes materialized."""
    sizes = ends - starts
    res = np.zeros(starts.size, dtype=bool)
    for n in np.unique(sizes):
        if n < _PRESCREEN_MIN_LEN:
            continue
        idxs = np.flatnonzero(sizes == n)
        rows = buf[starts[idxs][:, None] + np.arange(int(n))[None, :]]
        res[idxs] = _prescreen_group(rows)
    return res


def compress_block(data: bytes, codec: str) -> Tuple[bytes, int]:
    """Compress one block; fall back to raw storage when incompressible.

    Returns ``(payload, flag)`` with flag ∈ {RAW, COMPRESSED}.  The bypass
    decision (pre-screen + :data:`BYPASS_THRESHOLD`) is shared with
    :func:`compress_batch`, so the two are byte-identical per block.
    """
    if prescreen_bypass(data):
        return data, RAW
    c, _ = CODECS[resolve_codec(codec)]
    comp = c(data)
    if len(comp) >= BYPASS_THRESHOLD * len(data):
        return data, RAW
    return comp, COMPRESSED


def compress_batch(chunks: Sequence[bytes],
                   codec: str) -> Tuple[List[bytes], List[int]]:
    """Compress a flush group of blocks in a few vectorized passes.

    Per chunk: raw when the pre-screen bypasses it or the codec's payload
    fails :data:`BYPASS_THRESHOLD`, else the payload.  The surviving
    chunks share one match search / multi-frame call.
    """
    name = resolve_codec(codec)
    payloads: List[bytes] = [b""] * len(chunks)
    flags: List[int] = [RAW] * len(chunks)
    todo: List[int] = []
    for i, skip in enumerate(_prescreen_batch(chunks)):
        if skip:
            payloads[i] = chunks[i]
        else:
            todo.append(i)
    if todo:
        if name == "lz4":
            comps = lz4_compress_batch([chunks[i] for i in todo])
        elif name == "zstd":
            comps = zstd_compress_batch([chunks[i] for i in todo])
        else:
            c, _ = CODECS[name]
            comps = [c(chunks[i]) for i in todo]
        for i, comp in zip(todo, comps):
            if len(comp) >= BYPASS_THRESHOLD * len(chunks[i]):
                payloads[i] = chunks[i]
            else:
                payloads[i], flags[i] = comp, COMPRESSED
    return payloads, flags


def compress_slab(slab, starts: Sequence[int], ends: Sequence[int],
                  codec: str,
                  force: Optional[str] = None) -> Tuple[List[bytes], List[int]]:
    """:func:`compress_batch` over streams addressed INSIDE a flat slab.

    ``slab`` is a flat uint8 buffer — numpy, or a tensor straight from
    ``pack_planes_slab`` (on the card the match pipeline consumes it in
    place; the pre-screen and the emit read one host copy).
    ``starts[i]:ends[i]`` bounds stream ``i``.  Byte-identical payloads
    and flags to ``compress_batch([slab[s:e] ...], codec)``, but raw /
    bypassed payloads are sliced from the slab and LZ4 streams go to the
    match pipeline as (start, end) bounds.
    """
    name = resolve_codec(codec)
    starts = np.asarray(starts, dtype=np.int64).ravel()
    ends = np.asarray(ends, dtype=np.int64).ravel()
    S = int(starts.size)
    if isinstance(slab, torch.Tensor):
        slab = slab.reshape(-1)
        with spans.span("tier.wait", nbytes=slab.numel()):
            buf = slab.cpu().numpy()
    else:
        buf = np.asarray(slab, dtype=np.uint8).ravel()
    payloads: List[bytes] = [b""] * S
    flags: List[int] = [RAW] * S
    todo: List[int] = []
    with spans.span("tier.prescreen"):
        bypass = _prescreen_slab(buf, starts, ends)
    for i, skip in enumerate(bypass):
        if skip:
            payloads[i] = buf[starts[i]: ends[i]].tobytes()
        else:
            todo.append(i)
    if todo:
        tsel = np.asarray(todo, dtype=np.int64)
        if name == "lz4":
            comps = _lz4_slab_streams(slab, buf, starts[tsel], ends[tsel],
                                      force=force)
        elif name == "zstd":
            comps = zstd_compress_batch(
                [buf[starts[i]: ends[i]].tobytes() for i in todo])
        else:
            c, _ = CODECS[name]
            comps = [c(buf[starts[i]: ends[i]].tobytes()) for i in todo]
        for i, comp in zip(todo, comps):
            n = int(ends[i] - starts[i])
            if len(comp) >= BYPASS_THRESHOLD * n:
                payloads[i] = buf[starts[i]: ends[i]].tobytes()
            else:
                payloads[i], flags[i] = comp, COMPRESSED
    return payloads, flags


def decompress_block(payload: bytes, flag: int, codec: str,
                     orig_len: int) -> bytes:
    if flag == RAW:
        return payload
    _, d = CODECS[resolve_codec(codec)]
    return d(payload, max_out=orig_len)


def decompress_batch(payloads: Sequence[bytes], flags: Sequence[int],
                     codec: str, orig_lens: Sequence[int]) -> List[bytes]:
    """Inverse of :func:`compress_batch`: one codec resolve for the group."""
    _, d = CODECS[resolve_codec(codec)]
    with spans.span("tier.decompress") as sp:
        if sp:
            sp.nbytes = sum(map(len, payloads))
        return [
            pay if fl == RAW else d(pay, max_out=n)
            for pay, fl, n in zip(payloads, flags, orig_lens)
        ]


def ratio(orig: int, comp: int) -> float:
    """Compression ratio S_orig / S_comp (≥ 1 is a gain)."""
    return orig / max(comp, 1)
