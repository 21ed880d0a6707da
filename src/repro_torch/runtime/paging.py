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
exactly the stream a real host would store through CXL.mem.  Not ported
yet: shared-prefix reuse, prefetch and the reclaim ladder (``ROADMAP.md``
Queue 1).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.precision import FULL, MAN0, MAN4, PrecisionView
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


PAPER_POLICY = PagePolicy()           # Table II: 5×BF16 / 3×FP8 / 2×FP4
LOSSLESS_POLICY = PagePolicy(tiers=((1 << 30, FULL),), tail_view=FULL)


@dataclasses.dataclass
class _Page:
    key: str                  # stream id on the device
    layer: int
    kind: str                 # "k" | "v"
    start: int                # first token index
    n_tokens: int
    importance: float = 0.0
    resident: Optional[np.ndarray] = None   # HBM copy (token-major u16) or None
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


class KVPagePool:
    """Per-sequence paged KV with an HBM budget and tier spill.

    ``tier`` is a :class:`TierStore` (or a fleet) or a device kind, built
    on ``device`` (default: the card).  Importance scores for keys the
    pool does not track are counted in ``unknown_importance_keys`` and
    warned about once.
    """

    def __init__(
        self,
        tier: Union[TierStore, str] = "trace",
        page_tokens: int = 64,
        hbm_budget_bytes: int = 1 << 30,
        policy: PagePolicy = PAPER_POLICY,
        key_prefix: str = "",
        device: Union[str, torch.device, None] = None,
    ):
        self.tier = (make_device(tier, device=device)
                     if isinstance(tier, str) else tier)
        self.page_tokens = page_tokens
        self.hbm_budget = hbm_budget_bytes
        self.policy = policy
        self.key_prefix = key_prefix        # stream namespace on a shared device
        self.unknown_importance_keys = 0
        self._warned_unknown_importance = False
        self._pages: List[_Page] = []
        self._hbm_used = 0
        self.spill_events: List[_Page] = []   # drained by the serving engine
        self.page_traffic: Dict[str, PageTraffic] = {}
        self.io_service_s = 0.0       # serialized service time
        self.io_queue_delay_s = 0.0   # time spent queued behind other I/O
        self.pages_read = 0           # pages the tier has served back
        self.pages_gathered = 0       # winner pages PNM gathers shipped
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

    # -- write path -----------------------------------------------------------
    def append_pages(self, pages: Sequence[tuple]):
        """Commit a batch of ``(layer, kind, start, tokens_u16,
        importance)`` pages with ONE eviction pass at the end, so the
        spill it triggers is one write batch (one encode slab)."""
        for layer, kind, start, tokens_u16, importance in pages:
            key = f"{self.key_prefix}L{layer}.{kind}.{start}"
            page = _Page(key, layer, kind, start, tokens_u16.shape[0],
                         importance=importance)
            # admit to HBM first, then evict the least important
            page.resident = tokens_u16.copy()
            self._hbm_used += tokens_u16.size * 2
            self._pages.append(page)
        self._rebalance()

    def _rebalance(self):
        """Evict the least-important resident pages when over budget."""
        if self._hbm_used <= self.hbm_budget:
            return
        resident = sorted(
            (p for p in self._pages if p.resident is not None),
            key=lambda p: p.importance,
        )
        writes = []
        for p in resident:
            if self._hbm_used <= self.hbm_budget:
                break
            tok = p.resident
            self._hbm_used -= tok.size * 2
            p.resident = None
            self.spill_events.append(p)
            writes.append(WriteReq(p.key, tok, kind=KV, flush=True, tag=p.key))
        if writes:
            # posted through the async front-end: spill writes commit
            # eagerly, queued readback tickets stay in flight
            self._account([t.wait() for t in self.tier.submit_async(writes)])

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

    def read_layer(self, layer: int, kind: str) -> np.ndarray:
        """All pages of (layer, kind) in token order, spilled pages served
        by the tier (one request batch) at their policy view within the
        layer's ranking."""
        pages = sorted(
            (p for p in self._pages if p.layer == layer and p.kind == kind),
            key=lambda p: p.start,
        )
        rank = self._spill_ranks(pages)
        reqs = [ReadReq(p.key, kind=KV,
                        view=self.policy.view_for_rank(rank[p.key]), tag=p.key)
                for p in pages if p.resident is None]
        rs = self.tier.submit(reqs) if reqs else []
        self._account(rs)
        served = {r.key: r.data for r in rs}
        out = [p.resident if p.resident is not None else served[p.key]
               for p in pages]
        return np.concatenate(out, axis=0) if out else np.empty((0, 0), np.uint16)

    # -- teardown ---------------------------------------------------------------
    def release(self) -> int:
        """Retire this pool: delete every key it wrote (its namespace, or
        its own keys without a prefix) and drop HBM pages.  Returns the
        number of device keys freed."""
        if self.key_prefix:
            freed = self.tier.delete_prefix(self.key_prefix)
        else:
            keys = {p.key for p in self._pages}
            for k in keys:
                self.tier.delete(k)
            freed = len(keys)
        self._pages.clear()
        self.spill_events.clear()
        self._hbm_used = 0
        return freed

    # -- accounting ---------------------------------------------------------------
    @property
    def hbm_bytes(self) -> int:
        return self._hbm_used

    @property
    def spilled_pages(self) -> int:
        return sum(1 for p in self._pages if p.resident is None)

    def iter_pages(self) -> Tuple[_Page, ...]:
        """All committed pages in commit order (the handles
        :meth:`read_pages` and :meth:`gather_topk` take)."""
        return tuple(self._pages)

    def stats(self):
        return self.tier.stats
