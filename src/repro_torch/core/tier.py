"""Request-batched CXL Type-3 tier store — Plain / GComp / TRACE (Table III).

The host↔device boundary of the port, a counterpart of the reference's
``core/tier.py`` with the same request protocol, receipts, ledger, async
queue and sanitizer:

* hosts speak **typed requests** — :class:`WriteReq` / :class:`ReadReq`
  name a key, a payload kind (``tensor`` or ``kv`` stream), a precision
  view and an optional block range; :class:`GatherReq` (the PNM read
  mode) names candidate pages and a query digest, and the device ships
  back only the top-k pages;
* the device answers with **per-request receipts** — :class:`Receipt`
  carries the DRAM / link / index traffic and a first-order latency for
  exactly that request; :class:`DeviceStats` is the running aggregate;
* the internal representation is a **layout strategy** — raw words,
  words + codec (GComp) or TRACE's bit-plane substrate with the
  cross-token KV transform (Fig. 8).

The store lives on a ``device``: on the card, a write batch's encode slab
is packed by the bit-plane kernel and matched by the LZ4 pipeline there
(``kernels.bitplane`` / ``kernels.lz4``), and a gather's candidates are
scored there (``kernels.pnm_score``); the byte-level emit and the read
path's decode run on the host, in numpy, as in the reference.  Payload
bytes, flags, receipts (latency included) and ledger rows are identical
to the reference's for the same request sequence.

Asynchronous submission: ``submit_async`` posts writes immediately and
queues reads in a bounded in-flight window; queued reads execute as
coalesced groups on window overflow, ``Ticket.wait`` / ``drain``, or a
write-after-read fence over every key a queued request touches, and
their receipts carry queue delay from a device-global busy clock
(:meth:`LinkModel.schedule`).  Program order is kept per key, so async
execution is byte-identical to sync.  ``make_device(shards > 1)`` builds
a fleet (``core.sharding.ShardedTierStore``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import (
    Collection, Dict, List, Optional, Sequence, Set, Tuple, Union,
)

import numpy as np
import torch

from .. import devices
from ..kernels import bitplane as kbitplane
from . import codec as codecs
from .bitplane import BF16_BITS, BLOCK_ELEMS, iter_blocks, unpack_planes_subset
from .kv_transform import KVBlockMeta, kv_forward_batch, kv_inverse_batch
from .precision import EXP_BITS, FULL, SCORE, PrecisionView, reconstruct_u16

INDEX_ENTRY_BYTES = 64  # paper §III-D: one compact entry per 4 KB block

# Request payload kinds.
TENSOR = "tensor"
KV = "kv"


def _add(obj, **deltas):
    """Add ``deltas`` to accounting fields of a receipt, stats aggregate
    or ledger row.  With :func:`_put`, the only place this module mutates
    accounting fields (the reference's sanctioned-helper rule)."""
    for name, delta in deltas.items():
        setattr(obj, name, getattr(obj, name) + delta)  # tracecheck: disable=R3


def _put(obj, **values):
    """Set accounting fields (latency stamps, device id); see :func:`_add`."""
    for name, value in values.items():
        setattr(obj, name, value)  # tracecheck: disable=R3


# ---------------------------------------------------------------------------
# Typed requests + receipts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WriteReq:
    """Host→device write descriptor.

    ``kind=TENSOR``: ``data`` is any-shape uint16; stored block-by-block.
    ``kind=KV``: ``data`` is token-major ``(t, C)`` uint16 rows appended to
    the stream ``key``; full windows are committed as they fill and
    ``flush=True`` commits any partial window at the end of the request.
    """

    key: str
    data: np.ndarray
    kind: str = TENSOR
    flush: bool = True
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class ReadReq:
    """Device→host read descriptor: ``view`` selects the precision alias,
    ``block_range=(lo, hi)`` a slice of the key's block list."""

    key: str
    kind: str = TENSOR
    view: PrecisionView = FULL
    block_range: Optional[Tuple[int, int]] = None
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class GatherReq:
    """Device-side top-k gather descriptor (the PNM read mode).

    The host names the candidate ``keys`` (spilled KV pages resident on
    the device), a flat ``(channels,)`` float32 query ``digest`` and a
    winner count ``k``.  The device scores every candidate on the
    ``score_view`` plane subset (sign + exponent planes by default) and
    returns full-precision data for only the top-k pages.  ``views``
    optionally pins a per-key winner fetch view (position-aligned with
    ``keys``; ``FULL`` when omitted), so a gather at ``k >= len(keys)``
    is byte-identical to :class:`ReadReq` submissions at those views.
    Ties on equal scores break by candidate position.
    """

    keys: Tuple[str, ...]
    digest: np.ndarray
    k: int
    kind: str = KV
    views: Optional[Tuple[PrecisionView, ...]] = None
    score_view: PrecisionView = SCORE
    tag: str = ""

    @property
    def key(self) -> str:
        """First candidate key (routing and labels by ``request.key``)."""
        return self.keys[0] if self.keys else ""


Request = Union[WriteReq, ReadReq, GatherReq]


def _req_keys(req: Request) -> frozenset:
    """Every device key one request touches (hazard-fence granularity)."""
    if isinstance(req, GatherReq):
        return frozenset(req.keys)
    return frozenset((req.key,))


@dataclasses.dataclass
class GatherResult:
    """Winner set of one executed :class:`GatherReq`: ``scores`` for
    every candidate in ``keys`` order (f32); ``keys`` / ``indices`` /
    ``data`` for the winners in descending-score order, ``data`` holding
    the bytes a plain read of that key at its winner view returns."""

    keys: List[str]
    indices: List[int]
    scores: np.ndarray
    data: List[np.ndarray]


@dataclasses.dataclass
class Receipt:
    """Per-request traffic + latency accounting (and data, for reads).
    Field names mirror :class:`DeviceStats`; receipts sum to it exactly."""

    key: str
    op: str                       # "write" | "read"
    kind: str = TENSOR
    tag: str = ""
    blocks: int = 0
    dram_bytes_read: int = 0
    dram_bytes_written: int = 0
    dram_bytes_stored: int = 0    # capacity delta (writes)
    raw_bytes_stored: int = 0     # logical (uncompressed) delta (writes)
    link_bytes_in: int = 0
    link_bytes_out: int = 0
    index_bytes: int = 0
    index_hits: int = 0
    index_misses: int = 0
    codec_blocks: int = 0         # payload streams offered to the codec
    codec_bypass: int = 0         # ... of which were stored raw (§III-D)
    latency_s: float = 0.0        # delivery time: queue_delay_s + service
    queue_delay_s: float = 0.0    # wait behind earlier in-flight requests
    service_s: float = 0.0        # serialized service time (sync latency)
    device_compute_s: float = 0.0  # device-side PNM time (gathers only)
    device_id: int = 0
    data: Optional[np.ndarray] = None
    gather: Optional[GatherResult] = None   # winner set (gathers only)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """First-order service-time model for a receipt (paper §IV-B numbers).

    ``base_s`` is the fixed per-request overhead; :meth:`for_design`
    derives it from the calibrated controller pipeline (Table V
    load-to-use: Plain 71 / GComp 84 / TRACE 89 cycles @ 2 GHz).
    """

    ddr_bw: float = 256e9         # device-side DDR
    link_bw: float = 512e9        # CXL.mem per direction
    base_s: float = 1e-6          # fixed request overhead
    pnm_ops_s: float = 2e12       # near-memory scoring throughput (elem/s)

    @classmethod
    def for_design(cls, design: str, comp_ratio: float = 1.5,
                   **kw) -> "LinkModel":
        from .controller import load_to_use_ns

        return cls(base_s=load_to_use_ns(design, comp_ratio=comp_ratio)
                   * 1e-9, **kw)

    def latency(self, dram_bytes: int, link_bytes: int) -> float:
        return self.base_s + max(dram_bytes / self.ddr_bw,
                                 link_bytes / self.link_bw)

    def device_compute(self, elems: int) -> float:
        """Modelled time the device's near-memory unit spends scoring
        ``elems`` candidate elements for one gather (a third resource
        beside the DDR and link pipes: it extends delivery only)."""
        return elems / self.pnm_ops_s

    def schedule(
        self, traffic: Sequence[Tuple[int, int]],
        ddr_backlog_s: float = 0.0, link_backlog_s: float = 0.0,
    ) -> List[Tuple[float, float]]:
        """Completion model for one in-flight group sharing DDR + link:
        ``(queue_delay_s, latency_s)`` per ``(dram_bytes, link_bytes)``
        request, the fixed overhead paid once per group, behind any
        residual backlog of earlier groups."""
        out: List[Tuple[float, float]] = []
        cum_dram = cum_link = 0
        for dram, link in traffic:
            service = self.latency(dram, link)
            cum_dram += dram
            cum_link += link
            done = self.base_s + max(ddr_backlog_s + cum_dram / self.ddr_bw,
                                     link_backlog_s + cum_link / self.link_bw)
            out.append((max(done - service, 0.0), done))
        return out


@dataclasses.dataclass
class DeviceStats:
    """Running aggregate of every receipt the store has issued."""

    dram_bytes_stored: int = 0      # capacity footprint (compressed)
    dram_bytes_read: int = 0
    dram_bytes_written: int = 0
    link_bytes_out: int = 0
    link_bytes_in: int = 0
    index_bytes: int = 0
    index_hits: int = 0
    index_misses: int = 0
    blocks: int = 0
    raw_bytes_stored: int = 0       # logical (uncompressed) footprint
    codec_blocks: int = 0
    codec_bypass: int = 0
    device_compute_s: float = 0.0

    _SUMMED = ("dram_bytes_read", "dram_bytes_written", "dram_bytes_stored",
               "raw_bytes_stored", "link_bytes_in", "link_bytes_out",
               "index_bytes", "index_hits", "index_misses", "blocks",
               "codec_blocks", "codec_bypass", "device_compute_s")

    def reset_traffic(self):
        _put(self, dram_bytes_read=0, dram_bytes_written=0, link_bytes_out=0,
             link_bytes_in=0, index_bytes=0, index_hits=0, index_misses=0,
             device_compute_s=0.0)

    def apply(self, r: Receipt):
        _add(self, **{f: getattr(r, f) for f in self._SUMMED})


def _ns_match(key: str, prefix: str) -> bool:
    """Namespace-delimited prefix match: ``"r1"`` never claims ``r10.``."""
    if not prefix:
        return True
    if key == prefix:
        return True
    if not prefix.endswith("."):
        prefix += "."
    return key.startswith(prefix)


# ---------------------------------------------------------------------------
# Runtime invariant sanitizer (TRACE_SANITIZE=1 / TierStore(sanitize=True))
# ---------------------------------------------------------------------------

class SanitizerViolation(AssertionError):
    """A live accounting invariant broke under sanitize mode."""

    def __init__(self, invariant: str, key: str = "", expected=None,
                 actual=None, detail: str = ""):
        self.invariant = invariant
        self.key = key
        self.expected = expected
        self.actual = actual
        self.detail = detail
        msg = (f"[{invariant}] key={key!r} expected={expected!r} "
               f"actual={actual!r}")
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)


class _MirroredStats(DeviceStats):
    """DeviceStats whose ``reset_traffic`` also resets the sanitizer's
    shadow aggregate (direct field pokes still desync — on purpose)."""

    def __init__(self, mirror: DeviceStats):
        super().__init__()
        self._mirror = mirror

    def reset_traffic(self):
        super().reset_traffic()
        self._mirror.reset_traffic()


class _Sanitizer:
    """Invariant checks for one :class:`TierStore` at every commit
    boundary and retirement: ledger == stored bytes, receipts-sum ==
    stats, monotonic busy clock, in-flight window bound, retire cleanup
    and refcount conservation."""

    __slots__ = ("store", "shadow", "refs", "_now", "_ddr", "_link")

    _LEDGER_FIELDS = ("payload_bytes", "index_bytes", "raw_bytes", "blocks")
    _CAPACITY_FIELDS = ("dram_bytes_stored", "raw_bytes_stored", "blocks")

    def __init__(self, store: "TierStore"):
        self.store = store
        self.shadow = DeviceStats()
        self.refs: Dict[str, int] = {}
        self._now = self._ddr = self._link = 0.0

    def boundary(self, touched: Optional[Set[str]] = None):
        self.check_clock()
        self.check_window()
        self.check_ledger(touched)
        self.check_conservation()

    def check_clock(self):
        s = self.store
        for attr, last in (("_now_s", self._now), ("_ddr_free_s", self._ddr),
                           ("_link_free_s", self._link)):
            cur = getattr(s, attr)
            if cur < last - 1e-12:
                raise SanitizerViolation(
                    "busy-clock-monotonic", key=attr,
                    expected=f">= {last!r}", actual=cur,
                    detail="busy-clock frontier moved backwards",
                )
        self._now, self._ddr, self._link = (s._now_s, s._ddr_free_s,
                                            s._link_free_s)

    def check_window(self):
        s = self.store
        if len(s._queue) > s.window:
            raise SanitizerViolation(
                "inflight-window-bound", expected=f"<= {s.window}",
                actual=len(s._queue),
                detail="queued reads exceed the in-flight window",
            )

    def check_ledger(self, touched: Optional[Set[str]] = None):
        s = self.store
        if set(s._ledger) != set(s._tensors):
            only_l = sorted(set(s._ledger) - set(s._tensors))
            only_t = sorted(set(s._tensors) - set(s._ledger))
            raise SanitizerViolation(
                "ledger-stored-equality", key=(only_l + only_t)[0],
                expected="ledger keys == stored keys",
                actual=f"ledger-only={only_l[:3]} stored-only={only_t[:3]}",
            )
        keys = (s._ledger if touched is None
                else [k for k in touched if k in s._ledger])
        for key in keys:
            entry = s._ledger[key]
            blocks = s._tensors[key]
            want = (sum(b.stored_bytes for b in blocks),
                    len(blocks) * INDEX_ENTRY_BYTES,
                    sum(b.valid_elems for b in blocks) * 2, len(blocks))
            got = tuple(getattr(entry, f) for f in self._LEDGER_FIELDS)
            if want != got:
                raise SanitizerViolation(
                    "ledger-stored-equality", key=key,
                    expected=dict(zip(self._LEDGER_FIELDS, want)),
                    actual=dict(zip(self._LEDGER_FIELDS, got)),
                    detail="residency ledger row != stored bytes",
                )
            want_refs = self.refs.get(key, 1)
            if entry.refs != want_refs or entry.refs < 1:
                raise SanitizerViolation(
                    "refcount-conservation", key=key,
                    expected=want_refs, actual=entry.refs,
                    detail="ledger refcount drifted from the "
                           "acquire/release shadow",
                )
        totals = (sum(e.payload_bytes for e in s._ledger.values()),
                  sum(e.raw_bytes for e in s._ledger.values()),
                  sum(e.blocks for e in s._ledger.values()))
        stat = tuple(getattr(s.stats, f) for f in self._CAPACITY_FIELDS)
        if totals != stat:
            raise SanitizerViolation(
                "ledger-stored-equality",
                expected=dict(zip(self._CAPACITY_FIELDS, totals)),
                actual=dict(zip(self._CAPACITY_FIELDS, stat)),
                detail="ledger totals != stats capacity fields",
            )

    def check_conservation(self):
        for f in dataclasses.fields(DeviceStats):
            want = getattr(self.shadow, f.name)
            got = getattr(self.store.stats, f.name)
            if want != got:
                raise SanitizerViolation(
                    "receipt-conservation", key=f.name, expected=want,
                    actual=got,
                    detail="stats field drifted from the receipts-sum "
                           "shadow (mutated outside the sanctioned "
                           "helpers?)",
                )

    def check_retired(self, prefix: Optional[str] = None,
                      key: Optional[str] = None,
                      survivors: Collection[str] = ()):
        s = self.store

        def gone(k: str) -> bool:
            if k in survivors:
                return False
            return k == key if key is not None else _ns_match(k, prefix)

        stores = (("stored blocks", s._tensors), ("ledger", s._ledger),
                  ("shapes", s._shapes), ("kv staging", s._kv_staging),
                  ("kv channels", s._kv_channels))
        target = key if key is not None else prefix
        for what, d in stores:
            left = sorted(k for k in d if gone(k))
            if left:
                raise SanitizerViolation(
                    "retire-cleanup", key=target,
                    expected="no surviving entries",
                    actual=f"{what}: {left[:3]}",
                    detail="delete left orphaned keys behind",
                )
        left = sorted({k[0] for k in s._index._lru if gone(k[0])})
        if left:
            raise SanitizerViolation(
                "retire-cleanup", key=target,
                expected="no surviving entries",
                actual=f"index cache: {left[:3]}",
                detail="delete left orphaned index-cache entries behind",
            )


@dataclasses.dataclass
class _Block:
    """One 4 KB logical block in device DRAM."""

    payloads: List[bytes]            # per-plane (bit-plane) or single (word)
    flags: List[int]                 # codec.RAW / codec.COMPRESSED
    valid_elems: int                 # host-visible elements
    padded_elems: int                # elements the payloads encode (≥ valid)
    kv_meta: Optional[KVBlockMeta] = None
    view: Optional[PrecisionView] = None   # surviving view after truncation

    @property
    def stored_bytes(self) -> int:
        return sum(len(p) for p in self.payloads)


@dataclasses.dataclass
class ResidencyEntry:
    """One key's row in the physical-footprint residency ledger."""

    payload_bytes: int = 0      # stored (post-compression) plane payloads
    index_bytes: int = 0        # 64 B per committed block (metadata)
    raw_bytes: int = 0          # logical (uncompressed) footprint
    blocks: int = 0
    refs: int = 1               # outstanding references (shared pages > 1)

    @property
    def physical_bytes(self) -> int:
        return self.payload_bytes + self.index_bytes


class _EncodeSlab:
    """Per-posting-group staging area for deferred batched encoding: keys,
    receipts, chunks, valid counts, KV metas and untransformed KV windows
    in parallel lists, encoded in one pass and committed in order."""

    __slots__ = ("keys", "recs", "chunks", "valids", "metas", "kv_windows")

    def __init__(self):
        self.keys: List[str] = []
        self.recs: List[Receipt] = []
        self.chunks: List[Optional[np.ndarray]] = []
        self.valids: List[int] = []
        self.metas: List[Optional[KVBlockMeta]] = []
        self.kv_windows: List[Optional[np.ndarray]] = []

    def add(self, key: str, rec: Receipt, chunk: Optional[np.ndarray],
            valid: int, meta: Optional[KVBlockMeta] = None,
            kv_window: Optional[np.ndarray] = None):
        self.keys.append(key)
        self.recs.append(rec)
        self.chunks.append(chunk)
        self.valids.append(valid)
        self.metas.append(meta)
        self.kv_windows.append(kv_window)

    def clear(self):
        for lst in (self.keys, self.recs, self.chunks, self.valids,
                    self.metas, self.kv_windows):
            lst.clear()


class _IndexCache:
    """On-chip plane-index cache (paper Fig. 11, metadata management)."""

    def __init__(self, capacity_entries: int = 4096):
        self.capacity = capacity_entries
        self._lru: Dict[tuple, None] = {}

    def access(self, key: tuple) -> bool:
        hit = key in self._lru
        if hit:
            self._lru.pop(key)
        self._lru[key] = None
        if len(self._lru) > self.capacity:
            self._lru.pop(next(iter(self._lru)))
        return hit

    def evict_stream(self, stream: str):
        for k in [k for k in self._lru if k[0] == stream]:
            self._lru.pop(k)

    def evict_prefix(self, prefix: str):
        for k in [k for k in self._lru if _ns_match(k[0], prefix)]:
            self._lru.pop(k)


# ---------------------------------------------------------------------------
# Layout strategies — the device-internal representation
# ---------------------------------------------------------------------------

class Layout:
    """Encodes 4 KB blocks to payloads and decodes request batches back.

    ``plane_aligned``: a reduced view physically cuts DRAM traffic;
    ``kv_transform``: KV windows get the exponent-delta transform;
    ``uses_codec``: payloads go through the inline codec.
    """

    name = "layout"
    plane_aligned = False
    kv_transform = False
    uses_codec = False

    def encode_batch(self, chunks: Sequence[np.ndarray], codec: str,
                     device: torch.device
                     ) -> List[Tuple[List[bytes], List[int]]]:
        """Batch encode on ``device``: ``(payloads, flags)`` per chunk."""
        raise NotImplementedError

    def fetched_payloads(self, block: _Block, view: PrecisionView) -> Sequence[int]:
        """Payload indices a read with ``view`` physically touches."""
        raise NotImplementedError

    def decode_batch(self, blocks: Sequence[_Block], view: PrecisionView,
                     codec: str) -> List[np.ndarray]:
        """Per-block host-visible uint16 (valid-trimmed, reconstructed)."""
        raise NotImplementedError


class WordLayout(Layout):
    """Word-major containers; optional generic inline block compression."""

    def __init__(self, compress: bool):
        self.compress = compress
        self.uses_codec = compress
        self.name = "word-comp" if compress else "word"

    def encode_batch(self, chunks, codec, device):
        raws = [chunk.tobytes() for chunk in chunks]
        if self.compress:
            payloads, flags = codecs.compress_batch(raws, codec)
            return [([pay], [fl]) for pay, fl in zip(payloads, flags)]
        return [([raw], [codecs.RAW]) for raw in raws]

    def fetched_payloads(self, block, view):
        return (0,)

    def decode_batch(self, blocks, view, codec):
        if not blocks:
            return []
        raws = codecs.decompress_batch(
            [b.payloads[0] for b in blocks], [b.flags[0] for b in blocks],
            codec, [b.padded_elems * 2 for b in blocks],
        )
        outs = [np.frombuffer(raw, dtype=np.uint16)[: b.valid_elems]
                for raw, b in zip(raws, blocks)]
        if view.is_full:
            return [np.asarray(o) for o in outs]
        flat = reconstruct_u16(np.concatenate(outs), view)
        return _split_like(flat, outs)


class BitplaneLayout(Layout):
    """TRACE bit-plane substrate; plane-aligned fetch, vectorized batches."""

    plane_aligned = True
    uses_codec = True

    # Max elements packed+compressed per encode pass; groups split on
    # block boundaries past it (the reference's slab size, so the codec
    # sees the same slabs).
    ENCODE_SLAB_ELEMS = 128 * 1024
    # Max elements decoded per vectorized host pass.
    SLAB_ELEMS = 64 * 1024

    def __init__(self, kv_transform: bool = True):
        self.kv_transform = kv_transform
        self.name = "bitplane-kv" if kv_transform else "bitplane"

    def encode_batch(self, chunks, codec, device):
        if not chunks:
            return []
        for c in chunks:
            if c.size % 8:
                raise ValueError(f"block length {c.size} not a multiple of 8")
        out, cur, cur_n = [], [], 0
        for c in chunks:
            if cur and cur_n + c.size > self.ENCODE_SLAB_ELEMS:
                out.extend(self._encode_slab(cur, codec, device))
                cur, cur_n = [], 0
            cur.append(c)
            cur_n += c.size
        out.extend(self._encode_slab(cur, codec, device))
        return out

    def _encode_slab(self, chunks, codec, device):
        """One pack (on ``device``) + ONE compress_slab for every (plane,
        block) stream.  Blocks are byte-multiples, so packing the
        concatenation and slicing per block equals packing each alone;
        the planes go to the codec as one flat slab with stream bounds."""
        sizes = [c.size for c in chunks]
        planes = kbitplane.pack_planes_slab(
            np.concatenate(chunks) if len(chunks) > 1 else chunks[0].ravel(),
            device)
        offs = np.cumsum([0] + [n // 8 for n in sizes])
        nblk = len(chunks)
        n8 = planes.shape[1]
        base = np.arange(BF16_BITS, dtype=np.int64)[:, None] * n8
        payloads, flags = codecs.compress_slab(
            planes.reshape(-1),
            (base + offs[None, :-1]).ravel(),
            (base + offs[None, 1:]).ravel(),
            codec,
        )
        return [
            ([payloads[p * nblk + i] for p in range(BF16_BITS)],
             [flags[p * nblk + i] for p in range(BF16_BITS)])
            for i in range(nblk)
        ]

    def fetched_payloads(self, block, view):
        return view.fetched_planes()

    def decode_batch(self, blocks, view, codec):
        if len(blocks) > 1:
            slabs, cur, cur_elems = [], [], 0
            for b in blocks:
                if cur and cur_elems + b.padded_elems > self.SLAB_ELEMS:
                    slabs.append(cur)
                    cur, cur_elems = [], 0
                cur.append(b)
                cur_elems += b.padded_elems
            slabs.append(cur)
            if len(slabs) > 1:
                out = []
                for s in slabs:
                    out.extend(self.decode_batch(s, view, codec))
                return out
        if not blocks:
            return []
        plane_set = view.fetched_planes()
        nbytes = [b.padded_elems // 8 for b in blocks]
        total = sum(nbytes)
        rows = np.stack([
            np.frombuffer(
                b"".join(codecs.decompress_batch(
                    [b.payloads[p] for b in blocks],
                    [b.flags[p] for b in blocks], codec, nbytes,
                )),
                dtype=np.uint8,
            )
            for p in plane_set
        ])
        flat = unpack_planes_subset(rows, plane_set, total * 8)
        segs: List[np.ndarray] = []
        off = 0
        kv_groups: Dict[tuple, List[int]] = {}
        for bi, b in enumerate(blocks):
            seg = flat[off * 8 : off * 8 + b.valid_elems]
            off += nbytes[bi]
            if b.kv_meta is not None:
                m = b.kv_meta
                kv_groups.setdefault((m.n_tokens, m.n_channels), []).append(bi)
                seg = seg[: m.n_tokens * m.n_channels]
            segs.append(seg)
        # Invert the exponent-delta FIRST: guard rounding may carry from
        # mantissa into exponent, meaningful only in the real-exponent
        # domain.
        for idxs in kv_groups.values():
            metas = [blocks[i].kv_meta for i in idxs]
            inv = kv_inverse_batch(np.stack([segs[i] for i in idxs]), metas)
            for i, tok in zip(idxs, inv):
                segs[i] = tok
        if view.is_full:
            return segs
        flat = reconstruct_u16(np.concatenate([s.ravel() for s in segs]), view)
        return [r.reshape(s.shape) for r, s in zip(_split_like(flat, segs), segs)]


def _intersect_views(a: PrecisionView, b: PrecisionView) -> PrecisionView:
    """The widest view whose fetched planes are a subset of both ``a``'s
    and ``b``'s (how a read against a truncated block is served)."""
    if a == b:
        return a
    r_e = min(a.r_e, b.r_e)
    d_e = min(a.r_e + a.d_e, b.r_e + b.d_e) - r_e
    r_m = min(a.r_m, b.r_m)
    d_m = min(a.r_m + a.d_m, b.r_m + b.d_m) - r_m
    for v in (a, b):
        if (v.r_e, v.d_e, v.r_m, v.d_m) == (r_e, d_e, r_m, d_m):
            return v
    return PrecisionView(r_e=r_e, r_m=r_m, d_e=d_e, d_m=d_m,
                         name=f"cut{1 + r_e + r_m}")


def _split_like(flat: np.ndarray, segs: Sequence[np.ndarray]) -> List[np.ndarray]:
    out, off = [], 0
    for s in segs:
        out.append(flat[off : off + s.size])
        off += s.size
    return out


LAYOUTS = {
    "word": lambda: WordLayout(compress=False),
    "word-comp": lambda: WordLayout(compress=True),
    "bitplane": lambda: BitplaneLayout(kv_transform=False),
    "bitplane-kv": lambda: BitplaneLayout(kv_transform=True),
}


# ---------------------------------------------------------------------------
# Async submission — tickets over a bounded in-flight window
# ---------------------------------------------------------------------------

class Ticket:
    """Handle to one request submitted through :meth:`TierStore.submit_async`.
    Posted writes are born done; read tickets complete when their group
    flushes.  ``wait()`` is idempotent."""

    __slots__ = ("request", "_store", "_receipt", "_error")

    def __init__(self, store: "TierStore", request: Request):
        self._store = store
        self.request = request
        self._receipt: Optional[Receipt] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._receipt is not None or self._error is not None

    def _complete(self, receipt: Receipt):
        self._receipt = receipt

    def _fail(self, error: BaseException):
        self._error = error

    def wait(self) -> Receipt:
        if not self.done:
            self._store._flush_through(self)
        if self._error is not None:
            raise self._error
        assert self._receipt is not None
        return self._receipt

    def __repr__(self):
        state = ("done" if self._receipt is not None
                 else "failed" if self._error is not None else "pending")
        return f"Ticket({self.request.key!r}, {state})"


# ---------------------------------------------------------------------------
# TierStore — the host↔device boundary
# ---------------------------------------------------------------------------

class TierStore:
    """A tier device: a :class:`Layout` + codec behind a batched request
    API, with its encode kernels on ``device`` (default: the card)."""

    name = "tier"

    def __init__(self, layout: Union[Layout, str] = "word",
                 codec: str = "lz4", block_elems: int = BLOCK_ELEMS,
                 index_cache_entries: int = 4096, kv_window: int = 64,
                 link_model: LinkModel = LinkModel(), window: int = 64,
                 sanitize: Optional[bool] = None, device_id: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.device = devices.resolve(device)
        self.layout = LAYOUTS[layout]() if isinstance(layout, str) else layout
        self.codec = codecs.resolve_codec(codec)
        self.block_elems = block_elems
        self.kv_window = kv_window
        self.link_model = link_model
        self.device_id = device_id  # tracecheck: disable=R3  (config, not a tally)
        self.window = window                 # max queued (in-flight) reads
        if sanitize is None:
            sanitize = os.environ.get("TRACE_SANITIZE", "").strip() \
                not in ("", "0")
        self.sanitize = bool(sanitize)
        self._san = _Sanitizer(self) if self.sanitize else None
        self.stats = (_MirroredStats(self._san.shadow) if self._san
                      else DeviceStats())
        self._ledger: Dict[str, ResidencyEntry] = {}
        self._tensors: Dict[str, List[_Block]] = {}
        self._shapes: Dict[str, tuple] = {}
        self._kv_staging: Dict[str, list] = {}   # stream → [token rows]
        self._kv_channels: Dict[str, int] = {}
        self._index = _IndexCache(index_cache_entries)
        self._queue: List[Ticket] = []       # pending read tickets, FIFO
        # Device-global busy clock: host `now` + per-pipe busy frontiers.
        self._now_s = 0.0
        self._ddr_free_s = 0.0
        self._link_free_s = 0.0

    # -- validation ----------------------------------------------------------
    def _validate(self, requests: Sequence[Request]):
        """Reject a malformed batch BEFORE mutating any device state."""
        written = {req.key for req in requests if isinstance(req, WriteReq)}
        for req in requests:
            if isinstance(req, WriteReq):
                if req.kind not in (TENSOR, KV):
                    raise ValueError(f"unknown request kind {req.kind!r}")
            elif isinstance(req, ReadReq):
                if (req.kind == KV and self.layout.kv_transform
                        and req.view.r_e != EXP_BITS):
                    raise ValueError(
                        "KV views must keep the full (delta) exponent"
                    )
                if (req.key not in self._tensors
                        and not self._kv_staging.get(req.key)
                        and req.key not in written):
                    raise KeyError(req.key)
            elif isinstance(req, GatherReq):
                self._validate_gather(req, written)
            else:
                raise TypeError(f"not a tier request: {req!r}")

    def _validate_gather(self, req: GatherReq, written: Set[str]):
        if req.kind not in (TENSOR, KV):
            raise ValueError(f"unknown request kind {req.kind!r}")
        if req.k < 0:
            raise ValueError(f"gather k must be >= 0, got {req.k}")
        digest = np.asarray(req.digest)
        if digest.ndim != 1 or digest.size == 0:
            raise ValueError("gather digest must be a flat (channels,) vector")
        if req.views is not None and len(req.views) != len(req.keys):
            raise ValueError(f"gather views ({len(req.views)}) must align "
                             f"with keys ({len(req.keys)})")
        kv_exp = req.kind == KV and self.layout.kv_transform
        for view in (req.score_view,) + tuple(req.views or ()):
            if kv_exp and view.r_e != EXP_BITS:
                raise ValueError(
                    "KV views must keep the full (delta) exponent"
                )
        for key in req.keys:
            if (key not in self._tensors
                    and not self._kv_staging.get(key)
                    and key not in written):
                raise KeyError(key)
            c = self._kv_channels.get(key)
            if c is not None and c != digest.size:
                raise ValueError(f"gather digest has {digest.size} channels "
                                 f"but {key!r} stores {c}")

    def validate(self, requests: Sequence[Request]):
        """The checks :meth:`submit` runs before touching device state; a
        fleet pre-flights every shard's sub-batch through this, so a
        malformed fleet batch rejects before any shard commits."""
        self._validate(requests)

    # -- sanctioned accounting helpers ---------------------------------------
    def _apply_receipt(self, rec: Receipt):
        _put(rec, device_id=self.device_id)
        self.stats.apply(rec)
        if self._san is not None:
            self._san.shadow.apply(rec)

    def _adjust_stored(self, payload: int = 0, raw: int = 0,
                       blocks: int = 0):
        """Capacity delta outside a receipt (deletes, truncation)."""
        targets = [self.stats] + ([self._san.shadow] if self._san else [])
        for t in targets:
            _add(t, dram_bytes_stored=payload, raw_bytes_stored=raw,
                 blocks=blocks)

    def _sanitize_boundary(self, touched: Optional[Set[str]] = None):
        if self._san is not None:
            self._san.boundary(touched)

    # -- batched entry point -------------------------------------------------
    def submit(self, requests: Sequence[Request]) -> List[Receipt]:
        """Execute a request batch; one receipt per request, in order.
        Writes run first (one encode slab), then reads decode together;
        queued async reads drain first."""
        self._validate(requests)
        if self._queue:
            self._flush_queue(len(self._queue), wait=True)
        receipts: List[Receipt] = [None] * len(requests)  # type: ignore
        write_ix = [i for i, r in enumerate(requests)
                    if isinstance(r, WriteReq)]
        written = set(write_ix)
        read_ix = [i for i in range(len(requests)) if i not in written]
        if write_ix:
            for i, r in zip(write_ix,
                            self._post_writes([requests[i] for i in write_ix])):
                receipts[i] = r
        if read_ix:
            recs = self._do_reads([requests[i] for i in read_ix])
            self._schedule_group(
                recs, [(r.dram_bytes_read, r.link_bytes_out) for r in recs],
                wait=True,
            )
            for i, r in zip(read_ix, recs):
                receipts[i] = r
        return receipts

    # -- async entry point ---------------------------------------------------
    def submit_async(self, requests: Sequence[Request]) -> List[Ticket]:
        """Enqueue a request batch; one :class:`Ticket` per request.
        Writes post immediately (one encode slab); reads join the bounded
        in-flight window.  ``submit_async`` + :meth:`drain` is receipt-
        and byte-identical to one sync ``submit`` of the same batch."""
        self._validate(requests)
        writes = [r for r in requests if isinstance(r, WriteReq)]
        if writes:
            # write-after-read fence: queued reads (and gathers, over any
            # of their candidates) of a written key must not observe data
            # from their future
            hot = frozenset(w.key for w in writes)
            if any(hot & _req_keys(t.request) for t in self._queue):
                self._flush_queue(len(self._queue), wait=False)
        tickets: Dict[int, Ticket] = {}
        if writes:
            write_ix = [i for i, r in enumerate(requests)
                        if isinstance(r, WriteReq)]
            for i, rec in zip(write_ix, self._post_writes(writes)):
                t = Ticket(self, requests[i])
                t._complete(rec)
                tickets[i] = t
        for i, req in enumerate(requests):
            if i not in tickets:
                if len(self._queue) >= self.window:
                    self._flush_queue(len(self._queue), wait=False)
                t = Ticket(self, req)
                self._queue.append(t)
                tickets[i] = t
        if self._san is not None:
            self._san.check_window()
            self._san.check_clock()
        return [tickets[i] for i in range(len(requests))]

    def drain(self, tickets: Optional[Sequence[Ticket]] = None) -> List[Receipt]:
        """Execute everything queued; return the receipts of ``tickets``
        (default: the reads pending at call time), in order."""
        waiting = list(tickets) if tickets is not None else list(self._queue)
        if self._queue:
            self._flush_queue(len(self._queue), wait=True)
        return [t.wait() for t in waiting]

    def _flush_through(self, ticket: Ticket):
        try:
            n = self._queue.index(ticket) + 1
        except ValueError:
            return                       # completed (or failed) elsewhere
        self._flush_queue(n, wait=True)

    def _flush_queue(self, n: int, wait: bool = True):
        """Execute the first ``n`` queued reads as one coalesced group;
        ``wait`` marks flushes the host blocks on (they advance host time
        to the group's delivery)."""
        group, self._queue = self._queue[:n], self._queue[n:]
        if not group:
            return
        try:
            recs = self._do_reads([t.request for t in group])
        except BaseException as e:
            for t in group:
                t._fail(e)
            raise
        self._schedule_group(
            recs, [(r.dram_bytes_read, r.link_bytes_out) for r in recs],
            wait=wait,
        )
        for t, r in zip(group, recs):
            t._complete(r)

    # -- busy clock ----------------------------------------------------------
    def _schedule_group(self, recs: List[Receipt],
                        traffic: List[Tuple[int, int]], wait: bool):
        """Price one request group on the shared pipes (including residual
        backlog of earlier unwaited groups) and advance the busy clock."""
        if not recs:
            return
        now = self._now_s
        ddr_b = max(self._ddr_free_s - now, 0.0)
        link_b = max(self._link_free_s - now, 0.0)
        times = self.link_model.schedule(traffic, ddr_backlog_s=ddr_b,
                                         link_backlog_s=link_b)
        for rec, (delay, done) in zip(recs, times):
            _put(rec, queue_delay_s=delay,
                 latency_s=done + rec.device_compute_s)
        lm = self.link_model
        self._ddr_free_s = now + lm.base_s + ddr_b \
            + sum(t[0] for t in traffic) / lm.ddr_bw
        self._link_free_s = now + lm.base_s + link_b \
            + sum(t[1] for t in traffic) / lm.link_bw
        if wait:
            self._now_s = now + max(r.latency_s for r in recs)

    def quiesce(self):
        """Idle the host until both device pipes drain."""
        self._now_s = max(self._now_s, self._ddr_free_s, self._link_free_s)
        if self._san is not None:
            self._san.check_clock()

    # -- write path ----------------------------------------------------------
    def _post_writes(self, reqs: Sequence[WriteReq]) -> List[Receipt]:
        """Post a batch of writes as ONE encode slab — the single posting
        path of ``submit`` and ``submit_async``.  Writes are posted
        (CXL.mem semantics): they occupy the pipes, the host does not
        wait."""
        recs = [Receipt(key=r.key, op="write", kind=r.kind, tag=r.tag)
                for r in reqs]
        slab = _EncodeSlab()
        try:
            for req, rec in zip(reqs, recs):
                self._stage_write(req, rec, slab)
        finally:
            try:
                # even on a staging failure, everything staged so far
                # commits — sync semantics committed prior requests
                self._encode_commit(slab)
            finally:
                lm = self.link_model
                for rec in recs:
                    _put(rec, service_s=lm.latency(rec.dram_bytes_written,
                                                   rec.link_bytes_in))
                self._schedule_group(
                    recs,
                    [(r.dram_bytes_written, r.link_bytes_in) for r in recs],
                    wait=False,
                )
                for rec in recs:
                    self._apply_receipt(rec)
                self._sanitize_boundary({r.key for r in reqs})
        return recs

    def _stage_write(self, req: WriteReq, rec: Receipt, slab: "_EncodeSlab"):
        data = np.ascontiguousarray(req.data, dtype=np.uint16)
        _add(rec, link_bytes_in=data.size * 2)
        if req.kind == TENSOR:
            self._shapes[req.key] = data.shape
            for chunk, valid in iter_blocks(data, self.block_elems):
                slab.add(req.key, rec, chunk, valid)
            return
        rows = data[None, :] if data.ndim == 1 else data
        self._kv_channels[req.key] = rows.shape[-1]
        if not self.layout.kv_transform:
            # word devices store the token-major stream verbatim
            for chunk, valid in iter_blocks(rows, self.block_elems):
                slab.add(req.key, rec, chunk, valid)
            return
        buf = self._kv_staging.setdefault(req.key, [])
        flat = rows.reshape(-1, rows.shape[-1])
        nrows, i = flat.shape[0], 0
        while i < nrows:
            if not buf and nrows - i >= self.kv_window:
                # a whole window in one request: stage it directly
                slab.add(req.key, rec, None, self.kv_window * flat.shape[1],
                         kv_window=np.ascontiguousarray(
                             flat[i : i + self.kv_window]))
                i += self.kv_window
                continue
            take = min(self.kv_window - len(buf), nrows - i)
            buf.extend(flat[i : i + take])
            i += take
            if len(buf) >= self.kv_window:
                self._stage_kv_window(rec, req.key, slab)
        if req.flush and buf:
            self._stage_kv_window(rec, req.key, slab)

    def _stage_kv_window(self, rec: Receipt, stream: str,
                         slab: "_EncodeSlab"):
        """Claim the staged window now; its transform runs batched at
        encode time."""
        buf = self._kv_staging[stream]
        window = np.stack(buf, axis=0)
        buf.clear()
        slab.add(stream, rec, None, window.size, kv_window=window)

    def _encode_commit(self, slab: "_EncodeSlab"):
        """KV transform, plane pack, codec — then commit in staging order."""
        if not slab.chunks:
            return
        self._transform_kv_windows(slab)
        encoded = self.layout.encode_batch(slab.chunks, self.codec,
                                           self.device)
        for (payloads, flags), key, rec, chunk, valid, meta in zip(
                encoded, slab.keys, slab.recs, slab.chunks, slab.valids,
                slab.metas):
            self._commit(rec, key,
                         _Block(payloads, flags, valid, chunk.size,
                                kv_meta=meta))
        slab.clear()

    def _transform_kv_windows(self, slab: "_EncodeSlab"):
        """Resolve deferred KV windows: same-shape windows go through one
        ``kv_forward_batch``."""
        pend = [i for i, w in enumerate(slab.kv_windows) if w is not None]
        groups: Dict[tuple, List[int]] = {}
        for i in pend:
            groups.setdefault(slab.kv_windows[i].shape, []).append(i)
        for idxs in groups.values():
            streams, metas = kv_forward_batch(
                np.stack([slab.kv_windows[i] for i in idxs]))
            for i, row, meta in zip(idxs, streams, metas):
                slab.chunks[i] = (np.pad(row, (0, 8 - row.size % 8))
                                  if row.size % 8 else row)
                slab.metas[i] = meta
                slab.kv_windows[i] = None

    def _commit(self, rec: Receipt, key: str, block: _Block):
        self._tensors.setdefault(key, []).append(block)
        entry = self._ledger.setdefault(key, ResidencyEntry())
        if self._san is not None:
            self._san.refs.setdefault(key, 1)
        _add(entry, payload_bytes=block.stored_bytes,
             index_bytes=INDEX_ENTRY_BYTES, raw_bytes=block.valid_elems * 2,
             blocks=1)
        _add(rec, blocks=1, dram_bytes_stored=block.stored_bytes,
             dram_bytes_written=block.stored_bytes,
             raw_bytes_stored=block.valid_elems * 2)
        if self.layout.uses_codec:
            _add(rec, codec_blocks=len(block.flags),
                 codec_bypass=sum(1 for f in block.flags if f == codecs.RAW))

    def _commit_kv_window(self, rec: Receipt, stream: str):
        """Immediate window commit for the read path's implicit flush."""
        slab = _EncodeSlab()
        self._stage_kv_window(rec, stream, slab)
        self._encode_commit(slab)

    # -- read path -----------------------------------------------------------
    def _do_reads(self, reqs: Sequence[Request]) -> List[Receipt]:
        """Plain reads first, as one batch (every requested block
        gathered, traffic tallied per request, decoded per view-group),
        then gathers in listed order; receipts apply in a finally so a
        failure mid-batch cannot desync stats."""
        recs = [Receipt(key=r.key,
                        op="gather" if isinstance(r, GatherReq) else "read",
                        kind=r.kind, tag=r.tag)
                for r in reqs]
        try:
            read_ix = [i for i, r in enumerate(reqs)
                       if not isinstance(r, GatherReq)]
            if read_ix:
                self._gather_and_decode([reqs[i] for i in read_ix],
                                        [recs[i] for i in read_ix])
            for req, rec in zip(reqs, recs):
                if isinstance(req, GatherReq):
                    self._do_gather(req, rec)
            return recs
        finally:
            for rec in recs:
                self._apply_receipt(rec)
            touched: Set[str] = set()
            for r in reqs:
                touched |= _req_keys(r)
            self._sanitize_boundary(touched)

    def _fetch_keys(self, rec: Receipt, kind: str, keys: Sequence[str],
                    views: Sequence[PrecisionView]) -> List[np.ndarray]:
        """Plane-aligned fetch and host decode of whole keys at ``views``,
        tallied into ``rec`` — the per-block walk of
        :meth:`_gather_and_decode`."""
        per_key: List[List[Tuple[_Block, PrecisionView]]] = []
        for key, view in zip(keys, views):
            blocks = self._tensors.get(key, [])
            eff = [(b, view if b.view is None
                    else _intersect_views(view, b.view)) for b in blocks]
            for i, (b, v) in enumerate(eff):
                self._touch_index(rec, key, i)
                _add(rec, dram_bytes_read=sum(
                    len(b.payloads[p])
                    for p in self.layout.fetched_payloads(b, v)))
            per_key.append(eff)
        groups: Dict[PrecisionView, List[_Block]] = {}
        for eff in per_key:
            for b, v in eff:
                groups.setdefault(v, []).append(b)
        decoded = {v: iter(self.layout.decode_batch(blocks, v, self.codec))
                   for v, blocks in groups.items()}
        return [self._assemble(ReadReq(key, kind=kind, view=FULL),
                               [next(decoded[v]) for _, v in eff])
                for key, eff in zip(keys, per_key)]

    def _do_gather(self, req: GatherReq, rec: Receipt):
        """One PNM gather: decode every candidate at ``score_view`` on the
        host, score the pages on the tier's device (``kernels.pnm_score``),
        then fetch the top-k winners at their views.

        The scoring pass reads only the score view's planes from DRAM
        (plus index touches) and ships 4 B per candidate over the link;
        winners are fetched like plain reads.  ``device_compute_s`` is the
        modelled :meth:`LinkModel.device_compute` time over the scored
        elements, as in the reference, not a measured time."""
        from ..kernels.pnm_score import page_scores_u16, topk_select

        if req.kind == KV:
            for key in req.keys:
                if self._kv_staging.get(key):
                    # implicit flush, accounted to this gather
                    self._commit_kv_window(rec, key)
        candidates = self._fetch_keys(rec, req.kind, req.keys,
                                      [req.score_view] * len(req.keys))
        scores = page_scores_u16(
            candidates, np.asarray(req.digest, dtype=np.float32), self.device)
        _add(rec, link_bytes_out=4 * len(req.keys),
             device_compute_s=self.link_model.device_compute(
                 sum(int(c.size) for c in candidates)))

        winner_ix = topk_select(scores, req.k)
        winner_views = [req.views[i] if req.views is not None else FULL
                        for i in winner_ix]
        winner_keys = [req.keys[i] for i in winner_ix]
        data = self._fetch_keys(rec, req.kind, winner_keys, winner_views)
        if self.layout.plane_aligned:
            # truncated blocks clamp the view: ship each block's bits
            for key, view in zip(winner_keys, winner_views):
                for b in self._tensors.get(key, []):
                    v = view if b.view is None else _intersect_views(view,
                                                                     b.view)
                    n = b.valid_elems
                    if b.kv_meta is not None:
                        n = b.kv_meta.n_tokens * b.kv_meta.n_channels
                    _add(rec, link_bytes_out=n * v.bits // 8)
        else:
            _add(rec, link_bytes_out=sum(a.size for a in data)
                 * BF16_BITS // 8)
        lat = self.link_model.latency(rec.dram_bytes_read,
                                      rec.link_bytes_out) + rec.device_compute_s
        _put(rec, service_s=lat, latency_s=lat, gather=GatherResult(
            keys=winner_keys, indices=list(winner_ix), scores=scores,
            data=data))

    def _gather_and_decode(self, reqs: Sequence[ReadReq],
                           recs: List[Receipt]):
        req_blocks: List[List[_Block]] = []
        req_views: List[List[PrecisionView]] = []
        for req, rec in zip(reqs, recs):
            if req.kind == KV and self._kv_staging.get(req.key):
                # implicit flush, accounted to this request
                self._commit_kv_window(rec, req.key)
            blocks = self._tensors.get(req.key, [])
            if req.block_range is not None:
                lo, hi = req.block_range
                blocks = blocks[lo:hi]
            # a truncated block clamps the view to its surviving planes
            views = [req.view if b.view is None
                     else _intersect_views(req.view, b.view)
                     for b in blocks]
            for off, (b, view) in enumerate(zip(blocks, views)):
                base = (req.block_range[0] if req.block_range else 0) + off
                self._touch_index(rec, req.key, base)
                _add(rec, dram_bytes_read=sum(
                    len(b.payloads[p])
                    for p in self.layout.fetched_payloads(b, view)))
            req_blocks.append(list(blocks))
            req_views.append(views)

        # all blocks across requests, grouped by effective view, decode
        # once per group
        groups: Dict[PrecisionView, List[_Block]] = {}
        for views, blocks in zip(req_views, req_blocks):
            for view, b in zip(views, blocks):
                groups.setdefault(view, []).append(b)
        decoded = {
            view: iter(self.layout.decode_batch(blocks, view, self.codec))
            for view, blocks in groups.items()
        }
        for req, rec, views in zip(reqs, recs, req_views):
            segs = [next(decoded[view]) for view in views]
            rec.data = self._assemble(req, segs)
            # word devices always move full 16-bit containers (paper §II);
            # plane-aligned layouts return the effective view's bits
            if self.layout.plane_aligned:
                link = sum(seg.size * view.bits
                           for seg, view in zip(segs, views)) // 8
            else:
                link = rec.data.size * BF16_BITS // 8
            _add(rec, link_bytes_out=link)
            lat = self.link_model.latency(rec.dram_bytes_read,
                                          rec.link_bytes_out)
            _put(rec, service_s=lat, latency_s=lat)

    def _assemble(self, req: ReadReq, segs: List[np.ndarray]) -> np.ndarray:
        if not segs:
            return np.empty((0,), dtype=np.uint16)
        if req.kind == KV:
            if segs[0].ndim == 2:           # kv-transformed: (t, C) per window
                return np.concatenate(segs, axis=0)
            flat = np.concatenate(segs)
            C = self._kv_channels.get(req.key, flat.size)
            return flat.reshape(-1, C)
        flat = np.concatenate([s.ravel() for s in segs])
        shape = self._shapes.get(req.key)
        if (req.block_range is None and shape is not None
                and flat.size == int(np.prod(shape))):
            return flat.reshape(shape)
        return flat

    def _touch_index(self, rec: Receipt, key: str, i: int):
        if self._index.access((key, i)):
            _add(rec, index_hits=1)
        else:
            _add(rec, index_misses=1, index_bytes=INDEX_ENTRY_BYTES,
                 dram_bytes_read=INDEX_ENTRY_BYTES)

    # -- residency ledger -----------------------------------------------------
    def resident_bytes(self, prefix: str = "") -> int:
        """Physical bytes (payload + index) a namespace occupies now."""
        return sum(e.physical_bytes for k, e in self._ledger.items()
                   if _ns_match(k, prefix))

    def compression_ratio(self, prefix: str = "") -> float:
        """Observed logical/physical ratio of one namespace (1.0 if empty)."""
        raw = phys = 0
        for k, e in self._ledger.items():
            if _ns_match(k, prefix):
                raw += e.raw_bytes
                phys += e.physical_bytes
        return raw / phys if phys > 0 else 1.0

    def truncate_planes(self, keys: Sequence[str],
                        view: PrecisionView) -> int:
        """Drop stored planes outside ``view``'s fetched set in place and
        return the reclaimed payload bytes (paper §III-C: precision as a
        storage knob).  Plane-aligned layouts only; shared keys refused."""
        if not self.layout.plane_aligned:
            raise NotImplementedError(
                f"layout {self.layout.name!r} stores word-major "
                "containers; in-place plane truncation needs a "
                "plane-aligned layout"
            )
        for key in keys:
            entry = self._ledger.get(key)
            if entry is not None and entry.refs > 1:
                raise ValueError(
                    f"cannot truncate {key!r}: {entry.refs} references "
                    "hold this shared page"
                )
        if self._queue:
            self._flush_queue(len(self._queue), wait=True)
        keep = set(view.fetched_planes())
        reclaimed = 0
        for key in keys:
            blocks = self._tensors.get(key)
            if not blocks:
                continue
            freed = 0
            for b in blocks:
                if b.kv_meta is not None and view.r_e != EXP_BITS:
                    raise ValueError(
                        "KV views must keep the full (delta) exponent"
                    )
                for p in range(len(b.payloads)):
                    if p not in keep and b.payloads[p]:
                        freed += len(b.payloads[p])
                        b.payloads[p] = b""
                        b.flags[p] = codecs.RAW
                b.view = (view if b.view is None
                          else _intersect_views(b.view, view))
            if freed:
                _add(self._ledger[key], payload_bytes=-freed)
                self._adjust_stored(payload=-freed)
                reclaimed += freed
        self._sanitize_boundary(set(keys))
        return reclaimed

    def refcount(self, key: str) -> int:
        entry = self._ledger.get(key)
        return entry.refs if entry is not None else 0

    def acquire(self, key: str) -> int:
        """Take one more reference on a stored, untruncated key."""
        entry = self._ledger.get(key)
        if entry is None:
            raise KeyError(key)
        if any(b.view is not None for b in self._tensors.get(key, ())):
            raise ValueError(
                f"cannot acquire {key!r}: stored planes were truncated; "
                "a new referer would decode degraded data"
            )
        entry.refs += 1
        if self._san is not None:
            self._san.refs[key] = self._san.refs.get(key, 1) + 1
            self._san.boundary({key})
        return entry.refs

    def release(self, key: str) -> int:
        """Drop one reference; free the stored bytes at zero."""
        entry = self._ledger.get(key)
        if entry is None:
            raise KeyError(key)
        if entry.refs > 1:
            entry.refs -= 1
            if self._san is not None:
                self._san.refs[key] = self._san.refs.get(key, 1) - 1
                self._san.boundary({key})
            return entry.refs
        if self._queue:
            self._flush_queue(len(self._queue), wait=True)
        self._forget(key)
        if self._san is not None:
            self._san.boundary()
            self._san.check_retired(key=key)
        return 0

    def delete(self, key: str):
        entry = self._ledger.get(key)
        if entry is not None and entry.refs > 1:
            self.release(key)
            return
        if self._queue:
            self._flush_queue(len(self._queue), wait=True)
        self._forget(key)
        if self._san is not None:
            self._san.boundary()
            self._san.check_retired(key=key)

    def _forget(self, key: str, evict_index: bool = True):
        dropped = self._tensors.pop(key, [])
        if dropped:
            self._adjust_stored(
                payload=-sum(b.stored_bytes for b in dropped),
                raw=-sum(b.valid_elems for b in dropped) * 2,
                blocks=-len(dropped),
            )
        self._ledger.pop(key, None)
        self._shapes.pop(key, None)
        self._kv_staging.pop(key, None)
        self._kv_channels.pop(key, None)
        if self._san is not None:
            self._san.refs.pop(key, None)
        if evict_index:
            self._index.evict_stream(key)

    def delete_prefix(self, prefix: str) -> int:
        """Release every key of one namespace (blocks, staged windows,
        shapes, channel metadata, index entries); keys other referers hold
        drop one reference.  Returns the number of keys released."""
        if self._queue:
            self._flush_queue(len(self._queue), wait=True)
        keys = {k for k in self._tensors if _ns_match(k, prefix)}
        keys.update(k for k in self._kv_staging if _ns_match(k, prefix))
        keys.update(k for k in self._kv_channels if _ns_match(k, prefix))
        keys.update(k for k in self._shapes if _ns_match(k, prefix))
        survivors = set()
        for k in keys:
            entry = self._ledger.get(k)
            if entry is not None and entry.refs > 1:
                entry.refs -= 1
                if self._san is not None:
                    self._san.refs[k] = self._san.refs.get(k, 1) - 1
                survivors.add(k)
            else:
                self._forget(k, evict_index=False)
        if not survivors:
            self._index.evict_prefix(prefix)
        else:
            for k in keys - survivors:
                self._index.evict_stream(k)
        if self._san is not None:
            self._san.boundary()
            self._san.check_retired(prefix=prefix, survivors=survivors)
        return len(keys)


# ---------------------------------------------------------------------------
# Named device configurations (paper Table III)
# ---------------------------------------------------------------------------

class PlainDevice(TierStore):
    """CXL-Plain: word-major, no compression, full-container fetch."""

    name = "plain"

    def __init__(self, codec: str = "lz4", **kw):
        kw.setdefault("link_model", LinkModel.for_design("plain"))
        super().__init__(layout=WordLayout(compress=False), codec=codec, **kw)


class GCompDevice(TierStore):
    """CXL-GComp: word-major + generic inline 4 KB block compression."""

    name = "gcomp"

    def __init__(self, codec: str = "lz4", **kw):
        kw.setdefault("link_model", LinkModel.for_design("gcomp"))
        super().__init__(layout=WordLayout(compress=True), codec=codec, **kw)


class TraceDevice(TierStore):
    """TRACE: bit-plane substrate + KV transform + plane-aligned fetch."""

    name = "trace"

    def __init__(self, codec: str = "lz4", **kw):
        kw.setdefault("link_model", LinkModel.for_design("trace"))
        super().__init__(layout=BitplaneLayout(kv_transform=True),
                         codec=codec, **kw)


DEVICE_KINDS = {"plain": PlainDevice, "gcomp": GCompDevice, "trace": TraceDevice}


def make_device(kind: str, shards: Optional[int] = None,
                placement: Optional[str] = None,
                device: Union[str, torch.device, None] = None,
                **kw) -> TierStore:
    """Build a named tier device whose kernels run on ``device`` (default:
    the card), or a fleet of them.  ``shards`` above 1 returns a
    :class:`repro_torch.core.sharding.ShardedTierStore` of ``shards``
    devices of this kind, all on ``device``, placed by ``placement``
    (default ``hash-stripe``); ``shards=None`` defers to the
    ``TRACE_SHARDS`` env var."""
    if shards is None:
        raw = os.environ.get("TRACE_SHARDS", "").strip()
        shards = int(raw) if raw else 1
    if shards > 1:
        from .sharding import ShardedTierStore
        return ShardedTierStore(shards, kind, placement=placement,
                                device=device, **kw)
    return DEVICE_KINDS[kind](device=device, **kw)
