"""Paged KV management over an HBM + CXL(TRACE) tier (paper §II-C, Table II).

KV is managed as fixed-size pages (a window of tokens for all channels of
one layer's K or V).  Pages live in HBM while the hot budget lasts; the
least important spill to the tier device as ``WriteReq`` submissions and
are read back with batched ``ReadReq`` submissions at the precision their
spill rank earns under a :class:`PagePolicy`, or, in the PNM read mode,
with one ``GatherReq`` that ships back only the top-k spilled pages
(:meth:`KVPagePool.gather_topk`).  Every receipt folds into per-page
traffic counters.

The shipped policy mirrors Table II's best row: top pages BF16, next
~FP8 (man4 + guard), cold tail ~FP4 (man0 + guard).

Host arrays are BF16-as-uint16, token-major ``(tokens, channels)`` —
exactly the stream a real host would store through CXL.mem.

Precision-elastic reclamation: :meth:`KVPagePool.reclaim` frees tier
bytes without dropping tokens, walking cold spilled pages (least-recent
commit boundary first) one rung of a degradation ladder of
``PrecisionView`` s a pass through ``truncate_planes``.

Shared-prefix KV reuse: pools wired to one :class:`PrefixShareIndex`
store identical completed prompt-prefix pages once, under a
content-addressed ``shared.`` key named by a chained token-window hash
(:func:`prefix_chain_hashes`).  The first pool to spill a window writes
it; later pools acquire a refcounted ledger reference instead (windows
past the first differing token hash differently and stay private).  A
shared page frees with its last referer and is never degraded.

Prefetch: :meth:`KVPagePool.prefetch_layer` issues a layer's spilled
pages as async read tickets; a following :meth:`KVPagePool.read_layer`
takes their data when the view they were issued at still holds, and
every prefetch receipt folds into the pool's traffic exactly once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.precision import FULL, MAN0, MAN2, MAN4, PrecisionView
from ..core.tier import (
    GatherReq, KV, ReadReq, Receipt, Ticket, TierStore, WriteReq, make_device,
)


@dataclasses.dataclass(frozen=True)
class PagePolicy:
    """Importance-ranked precision assignment for *spilled* pages."""

    tiers: tuple = ((5, FULL), (3, MAN4), (2, MAN0))   # (count, view) in rank order
    tail_view: PrecisionView = MAN0                     # beyond listed tiers

    def view_for_rank(self, rank: int) -> PrecisionView:
        acc = 0
        for count, view in self.tiers:
            acc += count
            if rank < acc:
                return view
        return self.tail_view

    def avg_bits(self, n_pages: int) -> float:
        if n_pages == 0:
            return 16.0
        return float(
            np.mean([self.view_for_rank(r).bits for r in range(n_pages)])
        )


PAPER_POLICY = PagePolicy()           # Table II: 5×BF16 / 3×FP8 / 2×FP4
LOSSLESS_POLICY = PagePolicy(tiers=((1 << 30, FULL),), tail_view=FULL)


def prefix_chain_hashes(tokens: np.ndarray, page_tokens: int) -> List[str]:
    """Chained content hashes of the leading full token windows:
    ``hashes[w]`` digests tokens ``[0, (w+1)*page_tokens)`` of every batch
    row, so two prompts get equal ``hashes[w]`` iff they agree on every
    token through window ``w`` (the copy-on-write divergence rule).  A
    partial tail never hashes."""
    h = hashlib.sha1(str(page_tokens).encode())
    out: List[str] = []
    arr = np.ascontiguousarray(tokens)
    for w in range(arr.shape[-1] // page_tokens):
        h.update(arr[..., w * page_tokens:(w + 1) * page_tokens].tobytes())
        out.append(h.hexdigest()[:16])
    return out


def shared_page_key(share_hash: str, layer: int, kind: str) -> str:
    """Content-addressed tier key of one shared page: every request whose
    prompt contains the prefix computes the same key."""
    return f"shared.{share_hash}.L{layer}.{kind}"


class PrefixShareIndex:
    """Content-addressed index of the shared prefix pages on one tier.

    Maps a chain hash to the ``shared.`` keys holding that window's pages.
    The first pool to spill a window writes and :meth:`register` s it;
    later pools :meth:`acquire` a ledger reference instead of writing.
    All pools must serve one model: equal tokens imply equal KV only
    under equal parameters.
    """

    def __init__(self, tier: TierStore):
        self.tier = tier
        # chain hash → {(layer, kind): key}; only live (stored) pages
        self._nodes: Dict[str, Dict[Tuple[int, str], str]] = {}
        self._owner: Dict[str, Tuple[str, Tuple[int, str]]] = {}

    def acquire(self, share_hash: str, layer: int, kind: str) -> Optional[str]:
        """Take a reference on the stored copy of (hash, layer, kind), or
        return None when no pool has stored it yet."""
        key = self._nodes.get(share_hash, {}).get((layer, kind))
        if key is None:
            return None
        self.tier.acquire(key)
        return key

    def register(self, share_hash: str, layer: int, kind: str, key: str):
        """Record a freshly written shared page (its writer holds the
        first reference through the commit)."""
        self._nodes.setdefault(share_hash, {})[(layer, kind)] = key
        self._owner[key] = (share_hash, (layer, kind))

    def invalidate(self, key: str):
        """Drop a page from the index without releasing it."""
        owner = self._owner.pop(key, None)
        if owner is None:
            return
        share_hash, slot = owner
        node = self._nodes.get(share_hash)
        if node is not None:
            node.pop(slot, None)
            if not node:
                self._nodes.pop(share_hash, None)

    def release(self, key: str) -> int:
        """Drop one reference; unindex the page when the last one goes.
        Returns the remaining reference count."""
        left = self.tier.release(key)
        if left == 0:
            self.invalidate(key)
        return left

    def resident_chain(self, hashes: Sequence[str]) -> int:
        """How many leading windows of this chain have live shared pages
        (the scheduler's novel-KV admission discount)."""
        n = 0
        for h in hashes:
            if not self._nodes.get(h):
                break
            n += 1
        return n


# Default degradation ladder: each reclaim rung sheds further mantissa
# planes of cold stored pages in place (Table II's BF16 → ~FP8 → ~FP4).
DEFAULT_DEGRADE_LADDER = (MAN4, MAN2, MAN0)


@dataclasses.dataclass
class _Page:
    key: str                  # stream id on the device
    layer: int
    kind: str                 # "k" | "v" | "c_kv"
    start: int                # first token index
    n_tokens: int
    importance: float = 0.0
    resident: Optional[np.ndarray] = None   # HBM copy (token-major u16) or None
    commit_seq: int = 0       # commit boundary that admitted this page (LRU)
    degrade_level: int = -1   # last degradation-ladder rung applied
    share_hash: Optional[str] = None  # prefix chain hash (shareable window)
    shared_ref: bool = False  # this pool holds a ledger ref on a shared key
    gather_view: Optional[PrecisionView] = None  # frozen PNM winner view


@dataclasses.dataclass
class PageTraffic:
    """Per-page roll-up of the receipts this pool has seen."""

    dram_bytes_read: int = 0
    dram_bytes_written: int = 0
    link_bytes_in: int = 0
    link_bytes_out: int = 0
    index_bytes: int = 0
    device_compute_s: float = 0.0
    requests: int = 0

    def add(self, r: Receipt):
        """Fold one receipt in (field names shared with Receipt)."""
        for f in dataclasses.fields(self):
            if f.name != "requests":
                setattr(self, f.name, getattr(self, f.name) + getattr(r, f.name))
        self.requests += 1

    def merge(self, other: "PageTraffic"):
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


class KVPagePool:
    """Per-sequence paged KV with an HBM budget and tier spill.

    ``tier`` is a :class:`TierStore` (or a fleet) or a device kind, built
    on ``device`` (default: the card) with ``sanitize``.  Importance
    scores for keys the pool does not track are counted in
    ``unknown_importance_keys`` and warned about once.
    ``degrade_ladder`` is :meth:`reclaim` 's default ladder (empty: no
    reclamation); ``prefix_index``, built on the same tier, turns on
    shared-prefix reuse.
    """

    def __init__(
        self,
        tier: Union[TierStore, str] = "trace",
        page_tokens: int = 64,
        hbm_budget_bytes: int = 1 << 30,
        policy: PagePolicy = PAPER_POLICY,
        key_prefix: str = "",
        degrade_ladder: Sequence[PrecisionView] = (),
        sanitize: Optional[bool] = None,
        prefix_index: Optional[PrefixShareIndex] = None,
        device: Union[str, torch.device, None] = None,
    ):
        self.tier = (make_device(tier, device=device, sanitize=sanitize)
                     if isinstance(tier, str) else tier)
        self.page_tokens = page_tokens
        self.hbm_budget = hbm_budget_bytes
        self.policy = policy
        self.key_prefix = key_prefix        # stream namespace on a shared device
        self.degrade_ladder = tuple(degrade_ladder)
        if prefix_index is not None and prefix_index.tier is not self.tier:
            raise ValueError(
                "prefix_index must be built on this pool's tier: shared "
                "pages are acquired from the tier the index registers "
                "them on")
        self.prefix_index = prefix_index
        self.unknown_importance_keys = 0
        self._warned_unknown_importance = False
        self._pages: List[_Page] = []
        self._commit_clock = 0              # commit boundaries seen (page LRU)
        self._hbm_used = 0
        self.spill_events: List[_Page] = []   # drained by the serving engine
        self.page_traffic: Dict[str, PageTraffic] = {}
        self.io_service_s = 0.0       # serialized service time
        self.io_queue_delay_s = 0.0   # time spent queued behind other I/O
        self.pages_read = 0           # pages the tier has served back
        self.pages_gathered = 0       # winner pages PNM gathers shipped
        # key → [ticket, view at issue, receipt once accounted]
        self._prefetched: Dict[str, list] = {}
        # One page per KV window: the device commits each page's stream
        # in a single transform window.
        self.tier.kv_window = page_tokens

    def _account(self, receipts: Sequence[Receipt]):
        for r in receipts:
            self.page_traffic.setdefault(r.key, PageTraffic()).add(r)
            self.io_service_s += r.service_s
            self.io_queue_delay_s += r.queue_delay_s
            self.pages_read += r.op == "read"
            if r.gather is not None:
                self.pages_gathered += len(r.gather.keys)

    def traffic_by_layer(self) -> Dict[int, PageTraffic]:
        """Per-page traffic rolled up to layers."""
        out: Dict[int, PageTraffic] = {}
        for p in self._pages:
            t = self.page_traffic.get(p.key)
            if t is not None:
                out.setdefault(p.layer, PageTraffic()).merge(t)
        return out

    # -- write path -----------------------------------------------------------
    def append_page(self, layer: int, kind: str, start: int,
                    tokens_u16: np.ndarray, importance: float = 0.0):
        """Commit one full page (token-major ``(n, C)`` uint16)."""
        self.append_pages([(layer, kind, start, tokens_u16, importance)])

    def append_pages(self, pages: Sequence[tuple]):
        """Commit a batch of ``(layer, kind, start, tokens_u16,
        importance)`` pages, each with an optional sixth ``share_hash``,
        with ONE eviction pass at the end, so the spill it triggers is one
        write batch (one encode slab).  With a prefix index, share-tagged
        pages take the ``shared.`` key: residency and eviction are as for
        private pages, but the spill write is elided when the page is
        already stored (the pool acquires a reference instead)."""
        self._commit_clock += 1
        for entry in pages:
            layer, kind, start, tokens_u16, importance = entry[:5]
            share_hash = entry[5] if len(entry) > 5 else None
            if self.prefix_index is None:
                share_hash = None
            key = self.page_key(layer, kind, start, share_hash)
            page = _Page(key, layer, kind, start, tokens_u16.shape[0],
                         importance=importance,
                         commit_seq=self._commit_clock,
                         share_hash=share_hash)
            # admit to HBM first, then evict the least important
            page.resident = tokens_u16.copy()
            self._hbm_used += tokens_u16.size * 2
            self._pages.append(page)
        self._rebalance()

    def page_key(self, layer: int, kind: str, start: int,
                 share_hash: Optional[str] = None) -> str:
        """The tier key a committed page takes: its shared key when it
        carries a chain hash and the pool has a prefix index, else a key
        in the pool's namespace."""
        if share_hash is not None and self.prefix_index is not None:
            return shared_page_key(share_hash, layer, kind)
        return f"{self.key_prefix}L{layer}.{kind}.{start}"

    def _rebalance(self):
        """Evict the least-important resident pages when over budget."""
        if self._hbm_used <= self.hbm_budget:
            return
        resident = sorted(
            (p for p in self._pages if p.resident is not None),
            key=lambda p: p.importance,
        )
        writes = []
        fresh_shared: List[_Page] = []
        for p in resident:
            if self._hbm_used <= self.hbm_budget:
                break
            tok = p.resident
            self._hbm_used -= tok.size * 2
            p.resident = None
            self.spill_events.append(p)
            if p.share_hash is not None and self.prefix_index is not None:
                if self.prefix_index.acquire(
                        p.share_hash, p.layer, p.kind) is not None:
                    # already stored by another referer: take a reference
                    p.shared_ref = True
                    continue
                fresh_shared.append(p)
            writes.append(WriteReq(p.key, tok, kind=KV, flush=True, tag=p.key))
        if writes:
            # posted through the async front-end: spill writes commit
            # eagerly, queued readback tickets stay in flight
            self._account([t.wait() for t in self.tier.submit_async(writes)])
        for p in fresh_shared:
            # first writer: the commit's reference is this pool's claim
            self.prefix_index.register(p.share_hash, p.layer, p.kind, p.key)
            p.shared_ref = True

    def update_importance(self, scores: Dict[str, float]):
        """Re-rank pages by externally measured importance (the engine's
        attention mass), then rebalance residency.  Scores for keys the
        pool does not track are counted and warned about once."""
        known = {p.key for p in self._pages}
        unknown = [k for k in scores if k not in known]
        if unknown:
            self.unknown_importance_keys += len(unknown)
            if not self._warned_unknown_importance:
                self._warned_unknown_importance = True
                warnings.warn(
                    f"update_importance dropped scores for {len(unknown)} "
                    f"unknown page key(s) (e.g. {sorted(unknown)[:3]}); "
                    "see KVPagePool.unknown_importance_keys",
                    stacklevel=2,
                )
        for p in self._pages:
            if p.key in scores:
                p.importance = scores[p.key]
        self._rebalance()

    # -- read path --------------------------------------------------------------
    def _spill_ranks(self, pages=None) -> Dict[str, int]:
        spilled = sorted(
            (p for p in (pages if pages is not None else self._pages)
             if p.resident is None),
            key=lambda p: -p.importance,
        )
        return {p.key: i for i, p in enumerate(spilled)}

    def read_page(self, page: _Page) -> np.ndarray:
        """One spilled page through the tier at its current policy view."""
        return self.read_pages([page])[0]

    def _page_reqs(self, pages: Sequence[_Page]) -> List[ReadReq]:
        rank = self._spill_ranks()
        return [
            ReadReq(p.key, kind=KV, view=self.policy.view_for_rank(rank[p.key]),
                    tag=p.key)
            for p in pages
        ]

    def read_pages(self, pages: Sequence[_Page]) -> List[np.ndarray]:
        """Batched tier read of spilled pages (one submit for the batch)."""
        receipts = self.tier.submit(self._page_reqs(pages))
        self._account(receipts)
        return [r.data for r in receipts]

    def read_pages_async(self, pages: Sequence[_Page]) -> List[Ticket]:
        """Issue spill-readback tickets without waiting; views are fixed
        at issue time, so a later :meth:`drain_reads` returns the bytes a
        sync read here would have."""
        return self.tier.submit_async(self._page_reqs(pages))

    # -- PNM read path: device-side top-k gather -------------------------------
    def _gather_req(self, pages: Sequence[_Page], digest: np.ndarray,
                    k: int) -> GatherReq:
        """One :class:`GatherReq` over ``pages``.  Each candidate's winner
        view is frozen at its first gather — the policy view at the spill
        ranks of that moment, which classic readback would have issued —
        so ``k >= len(pages)`` ships exactly the readback bytes."""
        rank = None
        for p in pages:
            if p.gather_view is None:
                if rank is None:
                    rank = self._spill_ranks()
                p.gather_view = self.policy.view_for_rank(rank[p.key])
        return GatherReq(
            keys=tuple(p.key for p in pages),
            digest=np.asarray(digest, dtype=np.float32),
            k=int(k), kind=KV,
            views=tuple(p.gather_view for p in pages),
            tag=pages[0].key,
        )

    def _candidates(self, pages: Optional[Sequence[_Page]]) -> List[_Page]:
        return [p for p in (pages if pages is not None else self._pages)
                if p.resident is None]

    def gather_topk(self, digest: np.ndarray, k: int,
                    pages: Optional[Sequence[_Page]] = None,
                    ) -> Tuple[List[_Page], List[np.ndarray]]:
        """Device-side top-k over spilled pages (default: all of them):
        one ``GatherReq`` scores every candidate against ``digest`` and
        ships only the ``k`` winners → ``(winner_pages, data)`` in score
        order."""
        cands = self._candidates(pages)
        if not cands:
            return [], []
        rec = self.tier.submit([self._gather_req(cands, digest, k)])[0]
        return self._winners(cands, rec)

    def gather_topk_async(self, digest: np.ndarray, k: int,
                          pages: Optional[Sequence[_Page]] = None,
                          ) -> Tuple[List[_Page], Optional[Ticket]]:
        """:meth:`gather_topk` through the async front-end →
        ``(candidates, ticket)`` for :meth:`drain_gather` (``([], None)``
        when nothing is spilled)."""
        cands = self._candidates(pages)
        if not cands:
            return [], None
        ticket = self.tier.submit_async(
            [self._gather_req(cands, digest, k)])[0]
        return cands, ticket

    def drain_gather(self, cands: Sequence[_Page], ticket: Optional[Ticket],
                     ) -> Tuple[List[_Page], List[np.ndarray]]:
        """Wait one gather ticket → ``(winner_pages, data)``."""
        if ticket is None:
            return [], []
        return self._winners(cands, ticket.wait())

    def _winners(self, cands: Sequence[_Page], rec: Receipt
                 ) -> Tuple[List[_Page], List[np.ndarray]]:
        self._account([rec])
        by_key = {p.key: p for p in cands}
        return [by_key[k] for k in rec.gather.keys], rec.gather.data

    def drain_reads(self, tickets: Sequence[Ticket]) -> List[np.ndarray]:
        """Wait on readback tickets (draining the whole in-flight window
        if any is still queued), folding receipts into pool traffic."""
        if not tickets:
            return []
        if any(not t.done for t in tickets):
            receipts = self.tier.drain(tickets)
        else:
            receipts = [t.wait() for t in tickets]
        self._account(receipts)
        return [r.data for r in receipts]

    def prefetch_layer(self, layer: int, kind: str) -> int:
        """Issue async read tickets for (layer, kind)'s spilled pages, so
        a following :meth:`read_layer` is served from the in-flight
        window.  Returns the tickets issued (0 when everything is resident
        or already in flight)."""
        subset = [p for p in self._pages
                  if p.layer == layer and p.kind == kind]
        pages = [p for p in subset
                 if p.resident is None and p.key not in self._prefetched]
        if not pages:
            return 0
        # ranked within the (layer, kind) subset, as read_layer ranks, so
        # the issued views match and the prefetch is consumed
        rank = self._spill_ranks(subset)
        views = {p.key: self.policy.view_for_rank(rank[p.key]) for p in pages}
        reqs = [ReadReq(p.key, kind=KV, view=views[p.key], tag=p.key)
                for p in pages]
        for p, t in zip(pages, self.tier.submit_async(reqs)):
            self._prefetched[p.key] = [t, views[p.key], None]
        return len(pages)

    def _settle_prefetch(self, entry) -> Receipt:
        """Wait a prefetch ticket, folding its receipt into the pool's
        accounting exactly once."""
        if entry[2] is None:
            entry[2] = entry[0].wait()
            self._account([entry[2]])
        return entry[2]

    def settle_prefetched(self):
        """Account every prefetch ticket the tier has already executed
        (by window overflow or another request's flush), without forcing
        a queued one: receipts then sum to the tier's stats, a queued
        prefetch counting on neither side.  Settled data stays available
        to :meth:`read_layer`."""
        for entry in self._prefetched.values():
            if entry[0].done and entry[2] is None:
                self._settle_prefetch(entry)

    def read_layer(self, layer: int, kind: str) -> np.ndarray:
        """All pages of (layer, kind) in token order, spilled pages at
        their policy view within the layer's ranking: from a prefetch
        issued at that view, else from the tier (one request batch).  A
        prefetch whose view the ranking has since moved off stays
        accounted, and its page is read again."""
        pages = sorted(
            (p for p in self._pages if p.layer == layer and p.kind == kind),
            key=lambda p: p.start,
        )
        rank = self._spill_ranks(pages)
        served: Dict[str, np.ndarray] = {}
        reqs = []
        for p in pages:
            if p.resident is not None:
                continue
            view = self.policy.view_for_rank(rank[p.key])
            pf = self._prefetched.pop(p.key, None)
            if pf is not None:
                rec = self._settle_prefetch(pf)
                if pf[1] == view:
                    served[p.key] = rec.data
                    continue
            reqs.append(ReadReq(p.key, kind=KV, view=view, tag=p.key))
        rs = self.tier.submit(reqs) if reqs else []
        self._account(rs)
        served.update({r.key: r.data for r in rs})
        out = [p.resident if p.resident is not None else served[p.key]
               for p in pages]
        return np.concatenate(out, axis=0) if out else np.empty((0, 0), np.uint16)

    # -- precision-elastic reclamation -----------------------------------------
    def reclaim(self, target_bytes: int,
                ladder: Optional[Sequence[PrecisionView]] = None) -> int:
        """Reclaim up to ``target_bytes`` of stored tier bytes by shedding
        mantissa planes of cold spilled pages in place.

        Pages are walked coldest first (least-recent commit boundary, then
        least important), one ``ladder`` rung (default: the pool's
        ``degrade_ladder``) a pass, so every cold page degrades one step
        before any degrades two; a page's rung is remembered across calls.
        Shared pages are never touched.  A prefetch issued against a page
        before its truncation is settled and dropped: its data predates
        the degrade.  Returns the bytes reclaimed: 0 with an empty ladder,
        nothing spilled, the ladder exhausted, or a word layout, which
        cannot shed planes."""
        ladder = self.degrade_ladder if ladder is None else tuple(ladder)
        if target_bytes <= 0 or not ladder:
            return 0
        cold = sorted(
            (p for p in self._pages if p.resident is None),
            key=lambda p: (p.commit_seq, p.importance, p.start),
        )
        freed = 0
        for level, view in enumerate(ladder):
            for page in cold:
                if freed >= target_bytes:
                    return freed
                if page.degrade_level >= level or page.shared_ref:
                    continue
                try:
                    freed += self.tier.truncate_planes([page.key], view)
                except NotImplementedError:
                    return freed        # word layout: nothing to shed
                page.degrade_level = level
                # truncate_planes drained the queue, so a prefetch of this
                # page read the planes before the truncation
                pf = self._prefetched.pop(page.key, None)
                if pf is not None:
                    self._settle_prefetch(pf)
        return freed

    # -- teardown ---------------------------------------------------------------
    def release(self) -> int:
        """Retire this pool: settle its outstanding prefetches (their
        receipts fold in exactly once), drop its references on shared
        pages (through the index), delete every key it wrote (its
        namespace, or its own private keys without a prefix) and drop HBM
        pages.  Returns the number of device keys freed or released."""
        for entry in self._prefetched.values():
            self._settle_prefetch(entry)
        self._prefetched.clear()
        freed = 0
        for p in self._pages:
            if p.shared_ref:
                self.prefix_index.release(p.key)
                p.shared_ref = False
                freed += 1
        if self.key_prefix:
            freed += self.tier.delete_prefix(self.key_prefix)
        else:
            keys = {p.key for p in self._pages if not p.share_hash}
            for k in keys:
                self.tier.delete(k)
            freed += len(keys)
        self._pages.clear()
        self.spill_events.clear()
        self._hbm_used = 0
        return freed

    # -- accounting ---------------------------------------------------------------
    @property
    def hbm_bytes(self) -> int:
        return self._hbm_used

    @property
    def device_resident_bytes(self) -> int:
        """Physical bytes (payload + index) this pool's private namespace
        occupies on the tier now; shared pages are in
        :attr:`shared_resident_bytes`."""
        return self.tier.resident_bytes(self.key_prefix)

    @property
    def shared_resident_bytes(self) -> int:
        """Physical bytes of the shared pages this pool holds references
        on, summed per key (two pools on one stored copy each report its
        full size; ``resident_bytes("shared.")`` is the deduplicated
        total)."""
        return sum(self.tier.resident_bytes(p.key)
                   for p in self._pages if p.shared_ref)

    @property
    def physical_kv_bytes(self) -> int:
        """Live physical KV footprint: raw HBM pages plus the tier
        namespace's post-compression ledger bytes."""
        return self._hbm_used + self.device_resident_bytes

    @property
    def spilled_pages(self) -> int:
        return sum(1 for p in self._pages if p.resident is None)

    def iter_pages(self) -> Tuple[_Page, ...]:
        """All committed pages in commit order (the handles
        :meth:`read_pages` and :meth:`gather_topk` take)."""
        return tuple(self._pages)

    def stats(self):
        self.settle_prefetched()
        return self.tier.stats
