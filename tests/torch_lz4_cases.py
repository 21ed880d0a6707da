"""Slabs for the LZ4 match tests of the port (CPU and card): numpy only
and the port's own kernels, so the card tests can build them without JAX.

Each case is ``(buf, starts, ends)``: a flat uint8 slab and the bounds of
its streams (ascending, disjoint, gaps allowed), made from a seed.
"""

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.kernels import bitplane, kv_delta

_HASH_MUL = 2654435761


def _bounds(parts, gaps=None):
    """Concatenate ``parts`` (with ``gaps[i]`` filler bytes before part i)
    into one slab and return it with the parts' bounds."""
    rng = np.random.default_rng(99)
    gaps = gaps or [0] * len(parts)
    chunks, starts, ends, at = [], [], [], 0
    for part, gap in zip(parts, gaps):
        chunks.append(rng.integers(0, 256, gap, dtype=np.uint8))
        at += gap
        starts.append(at)
        chunks.append(np.asarray(part, dtype=np.uint8))
        at += len(part)
        ends.append(at)
    return (np.concatenate(chunks) if chunks else np.empty(0, np.uint8),
            np.asarray(starts, np.int64), np.asarray(ends, np.int64))


def kv_slab(seed: int = 3, windows: int = 16, tokens: int = 64,
            channels: int = 128):
    """An encode slab as the tier builds one: KV windows through the
    exponent-delta forward and the bit-plane pack, 16 planes x ``windows``
    streams of ``tokens * channels / 8`` bytes (256 x 1024 at the main
    path's shape).  Returns the slab, all streams' bounds and the bounds
    the pre-screen leaves to the match (the others are gaps)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((windows, tokens, channels)) * np.exp(
        rng.uniform(-3, 3, channels))
    u = (f.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    cm, _ = kv_delta.kv_forward(torch.from_numpy(u.view(np.int16)))
    planes = bitplane.pack_planes_u16(cm.reshape(-1))
    buf = planes.reshape(-1).numpy().view(np.uint8).copy()
    nb = tokens * channels // 8
    starts = (np.arange(16)[:, None] * planes.shape[1]
              + np.arange(windows)[None, :] * nb).ravel().astype(np.int64)
    ends = starts + nb
    keep = ~codec._prescreen_slab(buf, starts, ends)
    return buf, starts, ends, starts[keep], ends[keep]


def weight_slab(seed: int = 5, blocks: int = 64, block: int = 2048):
    """An encode slab as the weight store builds one: bf16 weights of
    random normal values times 0.02, cut into blocks of ``block`` words,
    16 planes x ``blocks`` streams of ``block / 8`` bytes (1024 x 256 at
    the weight path's shape); the bounds the pre-screen leaves to the
    match (the others are gaps)."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(blocks * block) * 0.02).astype(np.float32)
    u = (f.view(np.uint32) >> 16).astype(np.uint16)
    planes = bitplane.pack_planes_u16(torch.from_numpy(u.view(np.int16)))
    buf = planes.reshape(-1).numpy().view(np.uint8).copy()
    nb = block // 8
    starts = (np.arange(16)[:, None] * planes.shape[1]
              + np.arange(blocks)[None, :] * nb).ravel().astype(np.int64)
    ends = starts + nb
    keep = ~codec._prescreen_slab(buf, starts, ends)
    return buf, starts[keep], ends[keep]


def _hashes(buf):
    b = np.asarray(buf, np.uint64)
    w = b[:-3] | b[1:-2] << 8 | b[2:-1] << 16 | b[3:] << 24
    return (w * _HASH_MUL % (1 << 32)) >> 19


def _colliding_words():
    """Two different 4-byte words with the same hash."""
    w = np.arange(1, 1 << 16, dtype=np.uint64)
    h = (w * _HASH_MUL % (1 << 32)) >> 19
    order = np.argsort(h, kind="stable")
    i = np.flatnonzero(h[order][1:] == h[order][:-1])[0]
    return tuple(np.frombuffer(np.uint32(w[order[j]]).tobytes(), np.uint8)
                 for j in (i, i + 1))


def _far_pair(token, dist):
    """``token``, zeros, ``token`` again ``dist`` bytes after the first,
    zeros: no position between the two shares a hash with the token's."""
    out = np.zeros(dist + len(token) + 64, np.uint8)
    out[: len(token)] = token
    out[dist : dist + len(token)] = token
    h = _hashes(out)
    inner = h[len(token) : dist - 3]
    assert not np.isin(h[: len(token) - 3], inner).any()
    return out


def cases():
    """{name: (buf, starts, ends)}."""
    rng = np.random.default_rng(0)
    out = {}
    buf, s, e, sk, ek = kv_slab()
    out["kv_slab"] = (buf, s, e)
    out["kv_slab_prescreened"] = (buf, sk, ek)
    out["weight_slab"] = weight_slab()

    lens = list(range(17)) + [17, 255, 1024, 4096]
    parts = [rng.integers(0, 3, n, dtype=np.uint8) for n in lens]
    out["lengths"] = _bounds(parts)

    mixed = [np.where(rng.random(1024) < p, rng.integers(0, 256, 1024), 0)
             for p in (0.0, 0.01, 0.3, 1.0)]
    mixed.append(np.tile(rng.integers(0, 256, 13), 80))
    out["gapped"] = _bounds(mixed, gaps=[7, 0, 300, 1, 64])
    out["periodic_3900"] = _bounds(
        [np.tile(rng.integers(0, 256, 13), 300)])

    # one stream of 65537 bytes: noise, a long zero run and a long repeat
    big = rng.integers(0, 256, 65537, dtype=np.uint8)
    big[20000:50000] = 0
    big[60000:61000] = big[1000:2000]
    out["long_65537"] = _bounds([big, rng.integers(0, 2, 300)])

    # a repeat 65636 bytes back (> 0xFFFF: no candidate) and one 65535
    # back (a candidate)
    token = rng.integers(1, 256, 40, dtype=np.uint8)
    out["far_repeat"] = _bounds([_far_pair(token, 65636),
                                 _far_pair(token, 65535)])

    # the latest same-hash position holds another word: no candidate, even
    # though the same word occurs further back (no search down a chain)
    a, b = _colliding_words()
    noise = rng.integers(0, 256, 200, dtype=np.uint8)
    coll = np.concatenate([noise[:40], a, noise[40:80], b, noise[80:120], a,
                           noise[120:]])
    out["hash_collision"] = _bounds([coll, np.tile(a, 10)])

    # byte runs starting at every offset mod 4, short and long: the
    # run-stride rule keeps interior run candidates every 4th byte
    runs = []
    for off in range(4):
        for n in (4, 5, 6, 7, 9, 40):
            runs.append(np.concatenate([rng.integers(0, 256, off + 8),
                                        np.full(n, 7 + off),
                                        rng.integers(0, 256, 13)]))
    out["runs"] = _bounds(runs)

    # a cursor whose next candidate lies in the next stream: the first
    # stream's only match ends at its last match position, the next
    # stream starts with matches
    pat = rng.integers(0, 256, 6, dtype=np.uint8)
    first = np.concatenate([pat, pat, rng.integers(0, 256, 14)])
    out["next_stream"] = _bounds([first, np.tile(pat, 8), first])
    out.update(selection_cases(rng))
    return out


def selection_cases(rng):
    """Streams for the match kernel's selection rule: runs longer than
    the length cap, matches past 8 words (the lanes' reach) and around
    it, next candidates past 2 mask words, a chain of same-distance
    candidates broken by a hash collision, a stream with a single
    candidate, and streams shorter than MFLIMIT + 1."""
    out = {}
    # byte runs ending 1 byte before the cap (L - 5 - p), at it, and past
    # it, from several offsets
    runs = []
    for pre in (0, 1, 5, 9):
        for n in (20, 29, 64, 300):
            for tail in (0, 4, 5, 6):
                runs.append(np.concatenate([
                    rng.integers(0, 256, pre), np.full(n, 0xA5),
                    rng.integers(0, 0xA5, tail)]))
    out["runs_over_cap"] = _bounds(runs, gaps=[3] * len(runs))

    # a random block repeated at distance 300 with 35-37 and 100 bytes
    # equal, and a repeat that reaches the cap
    longm = []
    for n in (35, 36, 37, 40, 100, 160):
        blk = rng.integers(0, 256, n, dtype=np.uint8)
        longm.append(np.concatenate([blk, rng.integers(0, 256, 300 - n),
                                     blk, rng.integers(0, 256, 30)]))
    blk = rng.integers(0, 256, 200, dtype=np.uint8)
    longm.append(np.concatenate([blk, blk]))
    out["long_matches"] = _bounds(longm)

    # matches separated by 100-300 bytes of noise: the next candidate lies
    # 3-10 mask words on
    parts = []
    for gap in (70, 100, 200, 300):
        tok = rng.integers(0, 256, 12, dtype=np.uint8)
        parts += [tok, rng.integers(0, 256, gap, dtype=np.uint8), tok]
    out["far_next"] = _bounds([np.concatenate(parts)])

    # an 80-byte repeat at distance 100 whose copy holds, at one offset, a
    # word that collides with one written between original and copy: the
    # chain of distance-100 candidates breaks there and continues after
    a, b = _colliding_words()
    src = rng.integers(0, 256, 80, dtype=np.uint8)
    src[40:44] = a
    mid = rng.integers(0, 256, 20, dtype=np.uint8)
    mid[8:12] = b
    chain = np.concatenate([src, mid, src, rng.integers(0, 256, 40)])
    out["broken_chain"] = _bounds([chain, np.tile(src[:50], 6)])

    # one candidate: noise with one 6-byte repeat
    one = rng.integers(0, 256, 400, dtype=np.uint8)
    one[250:256] = one[50:56]
    short = [np.zeros(n, np.uint8) for n in range(14)]
    short += [np.tile(np.array([1, 2], np.uint8), 7)[:n] for n in range(14)]
    out["single_and_short"] = _bounds([one] + short)
    return out
