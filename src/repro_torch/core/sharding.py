"""Multi-device tier sharding: N :class:`TierStore` instances behind the
single-device protocol.

One ``TierStore`` models one CXL controller; :class:`ShardedTierStore`
fans a request batch out across ``n`` of them — each with its own
:class:`LinkModel` pipes, busy clock, ledger and sanitizer — and
reassembles per-request receipts in order, so ``KVPagePool`` and
``ServeEngine`` run on a fleet unchanged.  Every shard's kernels run on
the same torch device: a fleet is a model of several CXL devices, not of
several cards.

Routing is a :class:`Placement` policy (the ``PLACEMENTS`` registry):

* ``hash-stripe`` (default) — every key hashes to one home shard;
* ``namespace`` — keys route by their first ``.``-segment, pinning each
  engine's namespace (``r7.*``) to one device.

The reference's third policy, ``replicate-weights``, differs from
``hash-stripe`` only for ``TENSOR``-kind writes, which the port's serve
path does not make; it comes with the weights path.

A key's whole stream lives on one home shard, and ``shared.<hash>``
pages route by their ``shared.<hash>`` head, so bytes read back are
identical to a single device's.  A :class:`GatherReq` scatter-gathers:
each shard ranks its own candidates, and the host merges the local
winners into the global top-k with the same tie-break.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..kernels.pnm_score import topk_select
from .tier import (
    DEVICE_KINDS,
    DeviceStats,
    GatherReq,
    GatherResult,
    Receipt,
    Request,
    Ticket,
    TierStore,
)

SHARED_NS = "shared."


def _stable_hash(token: str) -> int:
    """Process-stable key hash (crc32): placement must not depend on
    ``PYTHONHASHSEED``."""
    return zlib.crc32(token.encode("utf-8"))


def shard_route_token(key: str) -> Optional[str]:
    """The pinned routing token of a ``shared.<hash>.…`` key (so every
    layer/kind page of one prefix window colocates), else None."""
    if key.startswith(SHARED_NS):
        parts = key.split(".", 2)
        if len(parts) > 1:
            return parts[0] + "." + parts[1]
    return None


class Placement:
    """Where keys live in the fleet: a routing token per key, mapped to a
    shard by a stable hash so every pool sharing the fleet agrees."""

    name = ""

    def __init__(self, n: int):
        self.n = n

    def _token(self, key: str) -> str:
        return key

    def owner(self, key: str) -> int:
        """The home shard of ``key``, stable for the key's lifetime."""
        token = shard_route_token(key)
        if token is None:
            token = self._token(key)
        return _stable_hash(token) % self.n


class HashStripePlacement(Placement):
    """Stripe every key by a stable full-key hash."""

    name = "hash-stripe"


class NamespacePlacement(Placement):
    """Pin each top-level namespace (``r7.*``) to one shard."""

    name = "namespace"

    def _token(self, key: str) -> str:
        return key.split(".", 1)[0]


PLACEMENTS: Dict[str, type] = {
    p.name: p for p in (HashStripePlacement, NamespacePlacement)
}


def _fleet_sum(field: str):
    return property(
        lambda self: sum(getattr(s.stats, field) for s in self._shards))


class FleetStats:
    """Live fleet-wide aggregate: every :class:`DeviceStats` field reads
    as the sum across shards at access time; ``reset_traffic`` fans out."""

    def __init__(self, shards: Sequence[TierStore]):
        self._shards = list(shards)

    def reset_traffic(self):
        for s in self._shards:
            s.stats.reset_traffic()


for _field in dataclasses.fields(DeviceStats):
    setattr(FleetStats, _field.name, _fleet_sum(_field.name))


class _MergedGatherTicket:
    """Ticket over one fleet-spanning :class:`GatherReq`: :meth:`wait`
    waits every shard's local top-k and merges them into one receipt
    (memoized, as :class:`Ticket` is)."""

    __slots__ = ("request", "_store", "_inner", "_per_pos", "_receipt",
                 "_error")

    def __init__(self, store: "ShardedTierStore", request: GatherReq,
                 inner: Sequence[Ticket], per_pos: Sequence[Sequence[int]]):
        self.request = request
        self._store = store
        self._inner = list(inner)
        self._per_pos = per_pos
        self._receipt: Optional[Receipt] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        if self._receipt is not None or self._error is not None:
            return True
        return all(t.done for t in self._inner)

    def wait(self) -> Receipt:
        if self._error is not None:
            raise self._error
        if self._receipt is None:
            try:
                recs = [t.wait() for t in self._inner]
            except BaseException as e:
                self._error = e
                raise
            self._receipt = self._store._merge_gather(
                self.request, recs, self._per_pos)
        return self._receipt


class ShardedTierStore:
    """N inner tier devices of one ``kind`` behind the single-device
    request protocol.  The remaining keyword arguments (``device``,
    ``sanitize``, ``window`` …) go to every shard; shard ``i`` gets
    ``device_id=i``, which its receipts carry."""

    name = "sharded"

    def __init__(self, n: int, kind: str,
                 placement: Union[str, Placement, None] = "hash-stripe",
                 **device_kw):
        if n < 1:
            raise ValueError(f"need at least one shard, got {n}")
        if placement is None:
            placement = "hash-stripe"
        self.placement = (PLACEMENTS[placement](n)
                          if isinstance(placement, str) else placement)
        self.shards = [DEVICE_KINDS[kind](device_id=i, **device_kw)
                       for i in range(n)]
        self.n_shards = n
        self.stats = FleetStats(self.shards)

    # -- routing -------------------------------------------------------------
    def owner(self, key: str) -> int:
        """Home shard index of ``key`` under the active placement."""
        return self.placement.owner(key)

    def _partition(self, requests: Sequence[Request]
                   ) -> Tuple[List[List[Request]], List[List[int]]]:
        """Per-shard sub-batches (relative order kept); ``slots[s][j]`` is
        the batch index the j-th request of shard s answers."""
        per: List[List[Request]] = [[] for _ in range(self.n_shards)]
        slots: List[List[int]] = [[] for _ in range(self.n_shards)]
        for idx, req in enumerate(requests):
            s = self.owner(req.key)
            per[s].append(req)
            slots[s].append(idx)
        return per, slots

    # -- fleet scatter-gather (PNM top-k) -------------------------------------
    def _split_gather(self, req: GatherReq
                      ) -> Tuple[List[Optional[GatherReq]], List[List[int]]]:
        """One sub-gather per shard holding candidates, keys in their
        relative (so global tie-break) order, ranked at ``min(k, local
        count)``: every global winner is in its own shard's top-k.
        ``per_pos[s][j]`` is the global position of shard s's j-th key."""
        per_keys: List[List[str]] = [[] for _ in range(self.n_shards)]
        per_pos: List[List[int]] = [[] for _ in range(self.n_shards)]
        for pos, key in enumerate(req.keys):
            s = self.owner(key)
            per_keys[s].append(key)
            per_pos[s].append(pos)
        subs: List[Optional[GatherReq]] = [None] * self.n_shards
        if not req.keys:
            # zero candidates: one well-formed empty gather on the
            # default-routed shard
            subs[self.owner(req.key)] = GatherReq(
                keys=(), digest=req.digest, k=0, kind=req.kind,
                views=None if req.views is None else (),
                score_view=req.score_view, tag=req.tag,
            )
            return subs, per_pos
        for s in range(self.n_shards):
            if not per_keys[s]:
                continue
            views = (tuple(req.views[p] for p in per_pos[s])
                     if req.views is not None else None)
            subs[s] = GatherReq(
                keys=tuple(per_keys[s]), digest=req.digest,
                k=min(req.k, len(per_keys[s])), kind=req.kind,
                views=views, score_view=req.score_view, tag=req.tag,
            )
        return subs, per_pos

    def _merge_gather(self, req: GatherReq, shard_recs: Sequence[Receipt],
                      per_pos: Sequence[Sequence[int]]) -> Receipt:
        """Fold per-shard local top-k receipts into one fleet receipt:
        scores in global candidate order, the global top-k re-selected
        with the single-device tie-break, byte and compute fields summed,
        latency the slowest shard's."""
        scores = np.full(len(req.keys), -np.inf, dtype=np.float32)
        data_by_pos: Dict[int, np.ndarray] = {}
        ri = iter(shard_recs)
        recs = [next(ri) if pos else None for pos in per_pos]
        for pos, rec in zip(per_pos, recs):
            if not pos:
                continue
            scores[list(pos)] = rec.gather.scores
            for idx, arr in zip(rec.gather.indices, rec.gather.data):
                data_by_pos[pos[idx]] = arr
        winner_ix = topk_select(scores, req.k)
        live = [r for r in recs if r is not None]
        summed = ("blocks", "dram_bytes_read", "dram_bytes_written",
                  "dram_bytes_stored", "raw_bytes_stored", "link_bytes_in",
                  "link_bytes_out", "index_bytes", "index_hits",
                  "index_misses", "codec_blocks", "codec_bypass",
                  "device_compute_s")
        return Receipt(
            key=req.key, op="gather", kind=req.kind, tag=req.tag,
            **{f: sum(getattr(r, f) for r in live) for f in summed},
            latency_s=max(r.latency_s for r in live),
            queue_delay_s=max(r.queue_delay_s for r in live),
            service_s=max(r.service_s for r in live),
            device_id=live[0].device_id,
            gather=GatherResult(
                keys=[req.keys[i] for i in winner_ix],
                indices=list(winner_ix), scores=scores,
                data=[data_by_pos[i] for i in winner_ix],
            ),
        )

    def _plan_gathers(self, requests: Sequence[Request]):
        """Split a mixed batch into (rest indices, per-shard rest, slots,
        gather plans), pre-validating every shard's combined sub-batch so
        a malformed fleet batch rejects before any shard commits."""
        gathers = [(i, r) for i, r in enumerate(requests)
                   if isinstance(r, GatherReq)]
        rest_ix = [i for i, r in enumerate(requests)
                   if not isinstance(r, GatherReq)]
        per, slots = self._partition([requests[i] for i in rest_ix])
        plans = [(i, self._split_gather(r)) for i, r in gathers]
        for s, shard in enumerate(self.shards):
            sub = list(per[s]) + [subs[s] for _, (subs, _pp) in plans
                                  if subs[s] is not None]
            if sub:
                shard.validate(sub)
        return rest_ix, per, slots, plans

    # -- batched entry points ------------------------------------------------
    def submit(self, requests: Sequence[Request]) -> List[Receipt]:
        """Execute a batch across the fleet; one receipt per request, in
        order, stamped with the serving shard's ``device_id``.  Writes and
        plain reads run first, then gathers in listed order (each
        scatter-gathered, one merged receipt)."""
        rest_ix, per, slots, plans = self._plan_gathers(requests)
        receipts: List[Optional[Receipt]] = [None] * len(requests)
        for shard, sub, sl in zip(self.shards, per, slots):
            if not sub:
                continue
            for i, rec in zip(sl, shard.submit(sub)):
                receipts[rest_ix[i]] = rec
        for i, (subs, per_pos) in plans:
            live = [(s, sub) for s, sub in enumerate(subs) if sub is not None]
            if len(live) == 1:
                # single-shard gather: the inner receipt is the answer
                s, sub = live[0]
                receipts[i] = self.shards[s].submit([sub])[0]
            else:
                recs = [self.shards[s].submit([sub])[0] for s, sub in live]
                receipts[i] = self._merge_gather(requests[i], recs, per_pos)
        return receipts  # type: ignore[return-value]

    def submit_async(self, requests: Sequence[Request]) -> List[Ticket]:
        """Enqueue a batch across the fleet; one ticket per request, in
        order — the owning shard's own ticket, or for a fleet-spanning
        gather a merged ticket whose ``wait`` merges the shards' local
        top-k exactly as :meth:`submit` does."""
        rest_ix, per, slots, plans = self._plan_gathers(requests)
        tickets: List[Optional[Ticket]] = [None] * len(requests)
        for shard, sub, sl in zip(self.shards, per, slots):
            if not sub:
                continue
            for i, t in zip(sl, shard.submit_async(sub)):
                tickets[rest_ix[i]] = t
        for i, (subs, per_pos) in plans:
            live = [(s, sub) for s, sub in enumerate(subs) if sub is not None]
            if len(live) == 1:
                s, sub = live[0]
                tickets[i] = self.shards[s].submit_async([sub])[0]
            else:
                inner = [self.shards[s].submit_async([sub])[0]
                         for s, sub in live]
                tickets[i] = _MergedGatherTicket(self, requests[i], inner,
                                                 per_pos)
        return tickets  # type: ignore[return-value]

    def drain(self, tickets: Optional[Sequence[Ticket]] = None
              ) -> List[Receipt]:
        """Flush every shard's queue; with ``tickets``, return exactly
        those receipts in order."""
        if tickets is None:
            out: List[Receipt] = []
            for shard in self.shards:
                out.extend(shard.drain())
            return out
        for shard in self.shards:
            shard.drain()
        return [t.wait() for t in tickets]

    def quiesce(self):
        """Idle the host until every shard's pipes drain."""
        for shard in self.shards:
            shard.quiesce()

    # -- single-device attribute surface -------------------------------------
    @property
    def kv_window(self) -> int:
        return self.shards[0].kv_window

    @kv_window.setter
    def kv_window(self, tokens: int):
        for shard in self.shards:
            shard.kv_window = tokens

    # -- fleet residency ledger ----------------------------------------------
    def resident_bytes(self, prefix: str = "") -> int:
        """Physical bytes a namespace occupies across the fleet."""
        return sum(s.resident_bytes(prefix) for s in self.shards)

    def delete(self, key: str):
        self.shards[self.owner(key)].delete(key)

    def delete_prefix(self, prefix: str) -> int:
        """Release one namespace fleet-wide; key counts sum over shards."""
        return sum(shard.delete_prefix(prefix) for shard in self.shards)

    # -- fleet view -----------------------------------------------------------
    def fleet_skew(self) -> float:
        """Max over mean of per-shard moved bytes (DRAM + link); 1.0 for
        a balanced fleet or when nothing moved yet."""
        moved = [s.stats.dram_bytes_read + s.stats.dram_bytes_written
                 + s.stats.link_bytes_in + s.stats.link_bytes_out
                 for s in self.shards]
        total = sum(moved)
        if total <= 0:
            return 1.0
        return max(moved) * self.n_shards / total
