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
  engine's namespace (``r7.*``) to one device;
* ``replicate-weights`` — hash-stripe for KV, but ``TENSOR``-kind writes
  (the weight store's units) land a full copy on every shard, returning
  the home shard's receipt, and tensor reads go to the least-busy
  replica (smallest :attr:`TierStore.busy_backlog_s`, ties to the lowest
  index).  The receipts-sum identity then holds per shard, not at the
  fleet view: a replicated write's bytes land on every shard.

A key's whole stream lives on one home shard (replicas are full
copies), and ``shared.<hash>``
pages route by their ``shared.<hash>`` head, so bytes read back are
identical to a single device's, and every layer/kind page of one prefix
window colocates: ``acquire`` / ``release`` / ``refcount`` and
``truncate_planes`` go to the owning shard, and the fleet refuses to
truncate a co-owned key before any shard sheds bytes.  A :class:`GatherReq` scatter-gathers:
each shard ranks its own candidates, and the host merges the local
winners into the global top-k with the same tie-break.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..kernels.pnm_score import topk_select
from .precision import FULL, PrecisionView
from .tier import (
    DEVICE_KINDS,
    KV,
    TENSOR,
    DeviceStats,
    GatherReq,
    GatherResult,
    LinkModel,
    ReadReq,
    Receipt,
    Request,
    Ticket,
    TierStore,
    WriteReq,
    _ns_match,
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

    def replicates(self, req: WriteReq) -> bool:
        """True when this write lands a full copy on every shard."""
        return False


class HashStripePlacement(Placement):
    """Stripe every key by a stable full-key hash."""

    name = "hash-stripe"


class NamespacePlacement(Placement):
    """Pin each top-level namespace (``r7.*``) to one shard."""

    name = "namespace"

    def _token(self, key: str) -> str:
        return key.split(".", 1)[0]


class ReplicateWeightsPlacement(HashStripePlacement):
    """Hash-stripe KV, replicate weights: ``TENSOR``-kind writes land on
    every shard and tensor reads go to the least-busy replica."""

    name = "replicate-weights"

    def replicates(self, req: WriteReq) -> bool:
        return req.kind == TENSOR


PLACEMENTS: Dict[str, type] = {
    p.name: p for p in (
        HashStripePlacement, NamespacePlacement, ReplicateWeightsPlacement,
    )
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

    @property
    def bypass_rate(self) -> float:
        return self.codec_bypass / max(self.codec_blocks, 1)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes_stored / max(self.dram_bytes_stored, 1)


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
    """N inner tier devices behind the single-device request protocol.

    Pass ``kind`` for a named device per shard, ``layout`` for a bare
    :class:`TierStore` per shard, or ``shard_factory`` (an ``i ->
    TierStore`` callable that must set ``device_id=i``) for full control,
    e.g. a fleet with a deliberately slow straggler.  ``link_models``
    overrides the pipe model per shard.  The remaining keyword arguments
    (``device``, ``window`` …) go to every shard; shard ``i`` gets
    ``device_id=i``, which its receipts carry.
    """

    name = "sharded"

    def __init__(self, n: int, kind: Optional[str] = None,
                 layout: Optional[str] = None,
                 placement: Union[str, Placement, None] = "hash-stripe",
                 link_models: Optional[Sequence[LinkModel]] = None,
                 sanitize: Optional[bool] = None,
                 shard_factory: Optional[Callable[[int], TierStore]] = None,
                 **device_kw):
        if n < 1:
            raise ValueError(f"need at least one shard, got {n}")
        if link_models is not None and len(link_models) != n:
            raise ValueError(
                f"link_models has {len(link_models)} entries for {n} shards")
        if placement is None:
            placement = "hash-stripe"
        self.placement = (PLACEMENTS[placement](n)
                          if isinstance(placement, str) else placement)
        shards: List[TierStore] = []
        for i in range(n):
            if shard_factory is not None:
                dev = shard_factory(i)
                if dev.device_id != i:
                    raise ValueError(
                        f"shard_factory({i}) built device_id="
                        f"{dev.device_id}; receipts could not attribute "
                        f"traffic — construct with device_id=i")
            else:
                kw = dict(device_kw, device_id=i)
                if link_models is not None:
                    kw["link_model"] = link_models[i]
                if sanitize is not None:
                    kw["sanitize"] = sanitize
                dev = (DEVICE_KINDS[kind](**kw) if kind is not None
                       else TierStore(layout=layout or "word", **kw))
            shards.append(dev)
        self.shards = shards
        self.n_shards = n
        self.stats = FleetStats(shards)
        self.sanitize = shards[0].sanitize
        # keys written under a replicating placement: their reads may go
        # to any shard, their deletes retire every copy
        self._replicated: set = set()

    # -- routing -------------------------------------------------------------
    def owner(self, key: str) -> int:
        """Home shard index of ``key`` under the active placement."""
        return self.placement.owner(key)

    @property
    def device(self):
        """The torch device every shard's kernels run on."""
        return self.shards[0].device

    def _read_shard(self, key: str) -> int:
        """Where a read of ``key`` goes: a replicated key's least-busy
        replica (ties to the lowest index), else its home shard."""
        if key in self._replicated:
            return min(range(self.n_shards),
                       key=lambda i: (self.shards[i].busy_backlog_s, i))
        return self.placement.owner(key)

    def _partition(self, requests: Sequence[Request]
                   ) -> Tuple[List[List[Request]], List[List[Optional[int]]]]:
        """Per-shard sub-batches (relative order kept); ``slots[s][j]`` is
        the batch index the j-th request of shard s answers, or None for a
        replica copy, whose receipt only its shard's stats keep."""
        per: List[List[Request]] = [[] for _ in range(self.n_shards)]
        slots: List[List[Optional[int]]] = [[] for _ in range(self.n_shards)]
        for idx, req in enumerate(requests):
            if isinstance(req, WriteReq):
                home = self.placement.owner(req.key)
                targets: Sequence[int] = (home,)
                if self.placement.replicates(req):
                    self._replicated.add(req.key)
                    targets = range(self.n_shards)
                for s in targets:
                    per[s].append(req)
                    slots[s].append(idx if s == home else None)
            else:
                s = self._read_shard(req.key)
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
            s = self._read_shard(key)
            per_keys[s].append(key)
            per_pos[s].append(pos)
        subs: List[Optional[GatherReq]] = [None] * self.n_shards
        if not req.keys:
            # zero candidates: one well-formed empty gather on the
            # default-routed shard
            subs[self._read_shard(req.key)] = GatherReq(
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
                if i is not None:
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
                if i is not None:
                    tickets[rest_ix[i]] = t
                else:
                    t.wait()     # a replica copy: born complete
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

    @property
    def pending(self) -> int:
        """Queued (not yet executed) reads across every shard's window."""
        return sum(s.pending for s in self.shards)

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

    @property
    def layout(self):
        return self.shards[0].layout

    @property
    def link_model(self) -> LinkModel:
        return self.shards[0].link_model

    @property
    def window(self) -> int:
        return self.shards[0].window

    @property
    def busy_backlog_s(self) -> float:
        """The fleet straggler: the largest per-shard pipe backlog."""
        return max(s.busy_backlog_s for s in self.shards)

    # -- per-key introspection (routed to the home shard) ---------------------
    def n_blocks(self, key: str) -> int:
        return self.shards[self.owner(key)].n_blocks(key)

    def footprint(self, key: str) -> int:
        return self.shards[self.owner(key)].footprint(key)

    def logical_bytes(self, key: str) -> int:
        return self.shards[self.owner(key)].logical_bytes(key)

    # -- fleet residency ledger ----------------------------------------------
    def resident_bytes(self, prefix: str = "") -> int:
        """Physical bytes a namespace occupies across the fleet (a
        replicated key counts once per copy: that is real DRAM)."""
        return sum(s.resident_bytes(prefix) for s in self.shards)

    def compression_ratio(self, prefix: str = "") -> float:
        """Logical/physical ratio of a namespace over the fleet (each
        shard's ratio weighted by its physical bytes; 1.0 if empty)."""
        raw = phys = 0.0
        for s in self.shards:
            p = s.resident_bytes(prefix)
            if p > 0:
                raw += s.compression_ratio(prefix) * p
                phys += p
        return raw / phys if phys > 0 else 1.0

    def truncate_planes(self, keys: Sequence[str],
                        view: PrecisionView) -> int:
        """In-place plane truncation on each key's home shard (every copy
        of a replicated key).  Refcounts are checked across the fleet
        first, so a co-owned page rejects before any shard sheds bytes."""
        if not self.layout.plane_aligned:
            raise NotImplementedError(
                f"layout {self.layout.name!r} stores word-major "
                "containers; in-place plane truncation needs a "
                "plane-aligned layout"
            )
        for key in keys:
            refs = self.refcount(key)
            if refs > 1:
                raise ValueError(
                    f"cannot truncate {key!r}: {refs} references "
                    "hold this shared page"
                )
        grouped: Dict[int, List[str]] = {}
        for key in keys:
            targets = (range(self.n_shards) if key in self._replicated
                       else (self.owner(key),))
            for s in targets:
                grouped.setdefault(s, []).append(key)
        return sum(self.shards[s].truncate_planes(sub, view)
                   for s, sub in grouped.items())

    # -- refcounted shared pages (on the home shard) --------------------------
    def refcount(self, key: str) -> int:
        return self.shards[self.owner(key)].refcount(key)

    def acquire(self, key: str) -> int:
        return self.shards[self.owner(key)].acquire(key)

    def release(self, key: str) -> int:
        return self.shards[self.owner(key)].release(key)

    def delete(self, key: str):
        if key in self._replicated:
            for shard in self.shards:
                shard.delete(key)
            self._replicated.discard(key)
        else:
            self.shards[self.owner(key)].delete(key)

    def delete_prefix(self, prefix: str) -> int:
        """Release one namespace fleet-wide; key counts sum over shards.
        A ``shared.<hash>`` namespace lives on one shard, so co-owned
        refcounts drop exactly once, there."""
        released = sum(shard.delete_prefix(prefix) for shard in self.shards)
        self._replicated = {k for k in self._replicated
                            if not _ns_match(k, prefix)}
        return released

    # -- fleet view -----------------------------------------------------------
    def per_device_stats(self) -> List[DeviceStats]:
        """Each shard's own :class:`DeviceStats`, indexed by device_id."""
        return [s.stats for s in self.shards]

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

    # -- legacy shims (forward to submit) ------------------------------------
    def write_tensor(self, name: str, u16: np.ndarray):
        self.submit([WriteReq(name, u16, kind=TENSOR)])

    def read_tensor(self, name: str, view: PrecisionView = FULL) -> np.ndarray:
        return self.submit([ReadReq(name, kind=TENSOR, view=view)])[0].data

    def write_kv(self, stream: str, tokens_u16: np.ndarray):
        self.submit([WriteReq(stream, tokens_u16, kind=KV, flush=False)])

    def read_kv(self, stream: str, view: PrecisionView = FULL) -> np.ndarray:
        return self.submit([ReadReq(stream, kind=KV, view=view)])[0].data

    def flush_kv(self, stream: str):
        self.shards[self.owner(stream)].flush_kv(stream)
