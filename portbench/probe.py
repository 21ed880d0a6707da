"""What the benchmark takes from the program while it serves: host spans
around the calls into its layers, the tier's byte counts from its
receipts, and each request's pages as they go into the tier and, read
from the cache once the readback has written it, as they come back.

The program's functions are wrapped where their callers look them up,
from outside, for the life of a :class:`Probe` (as the port's own smoke
script times a request); the program is not edited.  Host times are
``time.perf_counter_ns``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# span label -> (module under repro_torch, attribute its callers look up)
SPANS = {
    "tier write": ("core.tier", "TierStore._encode_commit"),
    "tier read": ("core.tier", "TierStore._do_reads"),
    "capture": ("runtime.serving", "DecodeGraph.__init__"),
}


# a digest reads this many bytes of int64 at a time (pages stacked)
DIGEST_CHUNK_BYTES = 16 << 20


def digest_weights(i):
    """The weight of word ``i`` of a page in its digest, 1..65521, so that
    a word moved or changed moves the sum (numpy or torch integers)."""
    return i * 40503 % 65521 + 1


def digest(words) -> int:
    """A page's digest: the sum of its 16-bit words, read as signed, each
    times its weight (exact in int64).  ``words``: the page's words in
    the cache's order, as int16 bit patterns or as 0..65535."""
    w = np.asarray(words).reshape(-1).astype(np.int64)
    w = np.where(w >= 0x8000, w - 0x10000, w)
    return int((w * digest_weights(np.arange(w.size, dtype=np.int64))).sum())


def cache_digests(engine, pages) -> "torch.Tensor":
    """The digest of each page's slots in ``engine``'s cache, worked out
    on the cache's device without a sync: (len(pages),) int64."""
    import torch

    layers, T = engine.cache["layers"], engine.page_tokens
    out, i = [], 0
    while i < len(pages):
        buf = layers[pages[i].kind]
        n = 1
        for d in buf.shape[1:]:
            n *= d
        n = n // buf.shape[2] * T
        step = max(1, DIGEST_CHUNK_BYTES // (8 * n))
        j = i
        while (j < len(pages) and j - i < step
               and pages[j].kind == pages[i].kind):
            j += 1
        slots = torch.stack([buf[p.layer, :, p.start:p.start + T]
                             for p in pages[i:j]])
        words = slots.view(torch.int16).reshape(j - i, n).to(torch.int64)
        out.append((words * digest_weights(torch.arange(
            n, dtype=torch.int64, device=buf.device))).sum(1))
        i = j
    return torch.cat(out)


@dataclasses.dataclass
class TierLog:
    """One request's pages through the tier: the words each page was
    committed with (kept for pages that spilled), the view each readback
    was issued at and the step that issued it, and for each readback
    written into the cache its pages' keys, the step that wrote them and
    the digests of their cache slots once written (on the device)."""

    committed: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    issued: Dict[str, Tuple[int, str]] = dataclasses.field(default_factory=dict)
    applied: List[Tuple[List[str], int, object]] = dataclasses.field(
        default_factory=list)

    def drop_resident(self):
        """Forget the words of pages that never spilled."""
        self.committed = {k: v for k, v in self.committed.items()
                          if k in self.issued}


class Probe:
    """Installs the wrappers; :meth:`close` takes them off.  ``step`` is
    set by the client before each call into the engine (0: the prefill,
    s: decode step s, one past the last: retire); ``log`` is the current
    request's :class:`TierLog` (None records nothing)."""

    def __init__(self):
        import importlib
        import inspect

        self.spans: Dict[str, List[Tuple[int, int]]] = {k: [] for k in SPANS}
        self.bytes = dict(write_raw=0, write_stored=0, read_stored=0,
                          read_decoded=0)
        self.step = 0
        self.log: Optional[TierLog] = None
        self._undo = []
        for label, (module, attr) in SPANS.items():
            owner = importlib.import_module(f"repro_torch.{module}")
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            raw = inspect.getattr_static(owner, name)
            self._patch(owner, name, self._span(label, raw))
        serving = importlib.import_module("repro_torch.runtime.serving")
        paging = importlib.import_module("repro_torch.runtime.paging")
        pool, engine = paging.KVPagePool, serving.ServeEngine
        self._patch(pool, "append_pages",
                    self._on_append(inspect.getattr_static(pool,
                                                           "append_pages")))
        self._patch(pool, "_page_reqs",
                    self._on_reqs(inspect.getattr_static(pool, "_page_reqs")))
        self._patch(pool, "_account",
                    self._on_account(inspect.getattr_static(pool,
                                                            "_account")))
        self._patch(engine, "_apply_readback",
                    self._on_readback(inspect.getattr_static(
                        engine, "_apply_readback")))

    def _patch(self, owner, name, fn):
        self._undo.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, fn)

    def close(self):
        for owner, name, raw in reversed(self._undo):
            if raw is None:
                delattr(owner, name)
            else:
                setattr(owner, name, raw)
        self._undo.clear()

    def _span(self, label, fn):
        depth, out = [0], self.spans[label]

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            t = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                out.append((t, time.perf_counter_ns()))
        return wrapped

    def _on_append(self, fn):
        probe = self

        @functools.wraps(fn)
        def wrapped(pool, pages):
            log = probe.log
            if log is not None:
                for entry in pages:
                    layer, kind, start, words = entry[:4]
                    share = entry[5] if len(entry) > 5 else None
                    log.committed[pool.page_key(layer, kind, start, share)] \
                        = words
            return fn(pool, pages)
        return wrapped

    def _on_reqs(self, fn):
        probe = self

        @functools.wraps(fn)
        def wrapped(pool, pages):
            reqs = fn(pool, pages)
            if probe.log is not None:
                for r in reqs:
                    probe.log.issued[r.key] = (probe.step, r.view.name)
            return reqs
        return wrapped

    def _on_account(self, fn):
        b = self.bytes

        @functools.wraps(fn)
        def wrapped(pool, receipts):
            for r in receipts:
                if r.op == "write":
                    b["write_raw"] += r.raw_bytes_stored
                    b["write_stored"] += r.dram_bytes_written
                elif r.op == "read":
                    b["read_stored"] += r.dram_bytes_read
                    b["read_decoded"] += 0 if r.data is None else r.data.nbytes
            return fn(pool, receipts)
        return wrapped

    def _on_readback(self, fn):
        probe = self

        @functools.wraps(fn)
        def wrapped(engine, pages, data):
            out = fn(engine, pages, data)
            if probe.log is not None and len(pages):
                probe.log.applied.append(([p.key for p in pages], probe.step,
                                          cache_digests(engine, pages)))
            return out
        return wrapped
