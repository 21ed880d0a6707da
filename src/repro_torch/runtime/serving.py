"""Serving engine with TRACE-tiered KV offload.

End-to-end path (paper Fig. 1/6 on a GPU host):

  prefill  — one forward over the prompt fills the KV cache on the card;
             completed pages (windows of ``page_tokens``) are copied to
             the host and committed to the ``KVPagePool`` as BF16
             token-major streams (the CXL.mem write stream of the paper).
  decode   — one-token steps attend through the decode-attention kernel
             over the cache, whose spilled pages were overwritten in place
             with the tier's readback at their policy precision.
  accounting — tier traffic from the pool's receipts;
             ``throughput_ceiling()`` converts it to a tok/s ceiling with
             the paper's first-order model.

I/O overlap (``async_io``, default on): spill readback tickets are issued
at one commit boundary and drained at the next, so they are in flight
across the decode steps between.  Tier reads are byte-identical either
way; under a lossless policy generation is identical to ``async_io=False``.

PNM read mode (``pnm_topk``): a boundary's spill readback becomes one
device-side top-k gather per KV kind against the query digest (the mean
of the last committed window's rows); losers keep their HBM values in
the cache, and ``pnm_topk`` covering the spill reads back exactly what
classic readback does.  ``importance="attention"`` ranks pages by the
digest-proxy attention mass accumulated at every boundary instead of
commit recency.  The digest and the masses are computed on the engine's
device; only the ``(C,)`` digest and one mass per window reach the host.

Not ported yet (``ROADMAP.md`` Queue 1): multi-stream engines and the
continuous-batching scheduler.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import devices
from ..configs.base import ArchConfig
from ..core.system_model import SystemSpec
from ..core.tier import Ticket, TierStore
from ..models.model import decode_step, init_cache
from .paging import KVPagePool, PagePolicy, PAPER_POLICY, _Page


def _sample_next(logits: np.ndarray, rng: np.random.Generator,
                 greedy: bool) -> np.ndarray:
    """Next-token ids from last-position logits."""
    if greedy:
        return logits.argmax(-1).astype(np.int32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.array([rng.choice(p.shape[-1], p=row) for row in p], np.int32)


@dataclasses.dataclass
class ServeStats:
    tokens_generated: int = 0
    prefill_tokens: int = 0
    hbm_page_bytes: int = 0
    tier_dram_read: int = 0
    tier_dram_stored: int = 0
    tier_link_out: int = 0
    spilled_pages: int = 0
    kv_logical_bytes: int = 0
    tier_io_service_s: float = 0.0      # serialized service time of all I/O
    tier_io_queue_delay_s: float = 0.0  # queueing on the shared DDR/link pipes
    tier_device_compute_s: float = 0.0  # PNM scoring time on the device

    @property
    def kv_compression_ratio(self) -> float:
        return self.kv_logical_bytes / max(
            self.tier_dram_stored + self.hbm_page_bytes, 1
        )


class ServeEngine:
    """Single-host serving of one model with paged, tiered KV, on
    ``device`` (default: the card).  ``params`` must live there."""

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        max_seq: int = 512,
        batch: int = 1,
        page_tokens: int = 64,
        hbm_kv_budget: int = 1 << 22,
        device_kind: Union[str, TierStore] = "trace",
        policy: PagePolicy = PAPER_POLICY,
        key_prefix: str = "",
        async_io: bool = True,
        pnm_topk: Optional[int] = None,
        importance: str = "recency",
        device: Union[str, torch.device, None] = None,
    ):
        assert not cfg.is_encoder_only, "serving needs a decoder"
        if importance not in ("recency", "attention"):
            raise ValueError(f"unknown importance mode {importance!r}")
        if pnm_topk is not None and pnm_topk < 0:
            raise ValueError("pnm_topk must be >= 0 (or None to disable)")
        self.device = devices.resolve(device)
        emb = params["embed"]
        if emb.device != self.device:
            raise ValueError(f"params live on {emb.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.async_io = async_io
        self.pnm_topk = pnm_topk
        self.importance = importance
        self._imp_acc: Dict[str, float] = {}    # accumulated attention mass
        self.pool = KVPagePool(
            device_kind, page_tokens, hbm_kv_budget, policy,
            key_prefix=key_prefix, device=self.device,
        )
        self.cache = init_cache(cfg, batch, max_seq, device=self.device)
        self.pos = 0
        self._inflight: List[Tuple[_Page, Ticket]] = []
        self._inflight_gathers: List[Tuple[List[_Page], Ticket]] = []

    # -- helpers ---------------------------------------------------------------
    def _commit_pages(self, lo: int, hi: int):
        """Push completed KV windows [lo, hi) into the page pool as one
        batched admission.  Only the completed windows leave the card."""
        # tickets issued at the previous boundary were in flight across
        # the decode steps that just ran — apply them before committing
        self.flush_io()
        layers = self.cache["layers"]
        batch_pages = []
        for start in range(lo - lo % self.page_tokens, hi, self.page_tokens):
            if start + self.page_tokens > hi:
                break
            for kind in ("k", "v"):
                win = layers[kind][:, :, start : start + self.page_tokens]
                # (L, B, page, KV, hd) → host, as 16-bit words
                host = win.cpu().contiguous().view(torch.int16).numpy()
                for layer in range(host.shape[0]):
                    tok = host[layer].reshape(self.page_tokens * self.batch, -1)
                    batch_pages.append((layer, kind, start,
                                        tok.view(np.uint16), float(start)))
        if batch_pages:
            if self.importance == "attention":
                batch_pages = self._apply_attention_importance(batch_pages)
            self.pool.append_pages(batch_pages)
        self._issue_readback()

    def _issue_readback(self):
        """Start spill readback for this boundary's evictions: sync mode
        reads and applies now, async mode issues tickets that
        :meth:`flush_io` applies at the next boundary."""
        events, self.pool.spill_events = self.pool.spill_events, []
        if not events:
            return
        if self.pnm_topk is not None:
            self._issue_gather(events)
            return
        if self.async_io:
            self._inflight.extend(
                zip(events, self.pool.read_pages_async(events))
            )
        else:
            self._apply_readback(events, self.pool.read_pages(events))

    def _issue_gather(self, events: Sequence[_Page]):
        """PNM read mode: one device-side top-k gather per KV kind over
        this boundary's evictions, against the kind's query digest; only
        the ``pnm_topk`` winners are read back into the cache."""
        by_kind: Dict[str, List[_Page]] = {}
        for p in events:
            by_kind.setdefault(p.kind, []).append(p)
        for kind, pages in by_kind.items():
            digest = self._digest(kind).cpu().numpy()
            if self.async_io:
                cands, ticket = self.pool.gather_topk_async(
                    digest, self.pnm_topk, pages)
                if ticket is not None:
                    self._inflight_gathers.append((cands, ticket))
            else:
                self._apply_readback(*self.pool.gather_topk(
                    digest, self.pnm_topk, pages))

    def flush_io(self):
        """Drain in-flight readback and gather tickets and fold them into
        the cache."""
        inflight, self._inflight = self._inflight, []
        gathers, self._inflight_gathers = self._inflight_gathers, []
        if inflight:
            pages = [p for p, _ in inflight]
            data = self.pool.drain_reads([t for _, t in inflight])
            self._apply_readback(pages, data)
        for cands, ticket in gathers:
            self._apply_readback(*self.pool.drain_gather(cands, ticket))

    def _digest(self, kind: str) -> torch.Tensor:
        """f32 mean of the last committed window's rows of ``kind``, over
        every layer and batch row, on the engine's device — the stand-in
        for the current query direction."""
        buf = self.cache["layers"][kind]               # (L, B, S, KV, hd)
        channels = buf.shape[3] * buf.shape[4]
        win = buf[:, :, max(0, self.pos - self.page_tokens):self.pos]
        if win.numel() == 0:
            return torch.zeros(channels, dtype=torch.float32,
                               device=buf.device)
        return win.float().reshape(-1, channels).mean(dim=0)

    def _attention_masses(self) -> Dict[Tuple[int, int], float]:
        """Digest-proxy attention mass per committed K window, keyed by
        ``(layer, start)``: every committed row's ``<row, digest>`` is
        softmaxed across the layer's whole committed context (all batch
        rows together), and a window's mass is the sum of its rows'
        probabilities.  Computed on the engine's device; one float per
        window goes to the host."""
        page = self.page_tokens
        paged = (self.pos // page) * page
        if paged <= 0:
            return {}
        buf = self.cache["layers"]["k"]
        L, B = buf.shape[:2]
        rows = buf[:, :, :paged].float().reshape(L, B * paged, -1)
        dots = rows @ self._digest("k")                # (L, B * paged)
        p = torch.exp(dots - dots.amax(dim=1, keepdim=True))
        p = p / p.sum(dim=1, keepdim=True)
        win = p.reshape(L, B, paged // page, page).sum(dim=(1, 3))
        win = win.cpu().numpy()
        return {(layer, w * page): float(win[layer, w])
                for layer in range(L) for w in range(paged // page)}

    def _apply_attention_importance(self, batch_pages: List[tuple]
                                    ) -> List[tuple]:
        """Fold this boundary's attention masses into the per-key running
        totals, re-rank the pool's live pages by them, and admit the
        fresh pages at their accumulated mass instead of recency.  V pages
        take their K twin's mass."""
        masses = self._attention_masses()
        if not masses:
            return batch_pages
        for p in self.pool.iter_pages():
            m = masses.get((p.layer, p.start))
            if m is not None:
                self._imp_acc[p.key] = self._imp_acc.get(p.key, 0.0) + m
        known = {p.key for p in self.pool.iter_pages()}
        scores = {k: v for k, v in self._imp_acc.items() if k in known}
        if scores:
            self.pool.update_importance(scores)
        out = []
        for layer, kind, start, u16, imp in batch_pages:
            key = f"{self.pool.key_prefix}L{layer}.{kind}.{start}"
            m = masses.get((layer, start))
            if m is not None:
                self._imp_acc[key] = self._imp_acc.get(key, 0.0) + m
                imp = self._imp_acc[key]
            out.append((layer, kind, start, u16, imp))
        return out

    def _apply_readback(self, pages: Sequence[_Page],
                        data: Sequence[np.ndarray]):
        """Overwrite spilled pages' cache slots in place with the
        tier-served values at their policy precision, so generation
        quality reflects the device pipeline."""
        layers = self.cache["layers"]
        for page, u16 in zip(pages, data):
            buf = layers[page.kind]
            target = buf[page.layer, :, page.start : page.start + self.page_tokens]
            words = torch.from_numpy(
                np.ascontiguousarray(u16).view(np.int16).copy())
            target.copy_(words.view(buf.dtype).reshape(target.shape))

    # -- API ---------------------------------------------------------------------
    def _step(self, tokens: np.ndarray) -> np.ndarray:
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(
                     tokens, dtype=np.int64)).to(self.device),
                 "cache_pos": self.pos}
        logits, self.cache = decode_step(self.cfg, self.params, batch,
                                         self.cache)
        old = self.pos
        self.pos += tokens.shape[1]
        self._commit_pages(old, self.pos)
        return logits[:, -1].float().cpu().numpy()

    def prefill(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (batch, prompt_len) → last-token logits (f32)."""
        assert tokens.shape[0] == self.batch
        return self._step(tokens)

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (batch, 1) current token → next-token logits (f32)."""
        return self._step(tokens.reshape(self.batch, 1))

    def generate(self, prompt: np.ndarray, n_tokens: int,
                 greedy: bool = True, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        logits = self.prefill(prompt)
        out = []
        for _ in range(n_tokens):
            nxt = _sample_next(logits, rng, greedy)
            out.append(nxt)
            logits = self.decode(nxt.reshape(-1, 1))
        return np.stack(out, axis=1)

    def stats(self) -> ServeStats:
        self.flush_io()
        d = self.pool.stats()
        return ServeStats(
            tokens_generated=self.pos,
            hbm_page_bytes=self.pool.hbm_bytes,
            tier_dram_read=d.dram_bytes_read,
            tier_dram_stored=d.dram_bytes_stored,
            tier_link_out=d.link_bytes_out,
            spilled_pages=self.pool.spilled_pages,
            kv_logical_bytes=d.raw_bytes_stored + self.pool.hbm_bytes,
            tier_io_service_s=self.pool.io_service_s,
            tier_io_queue_delay_s=self.pool.io_queue_delay_s,
            tier_device_compute_s=d.device_compute_s,
        )

    def throughput_ceiling(self, sys: SystemSpec = SystemSpec()) -> float:
        """tok/s ceiling implied by current per-step tier traffic."""
        d = self.pool.stats()
        steps = max(self.pos, 1)
        ddr_per_step = d.dram_bytes_read / steps
        link_per_step = d.link_bytes_out / steps
        t = max(ddr_per_step / sys.cxl_ddr_bw,
                link_per_step / sys.cxl_link_bw, 1e-12)
        return min(1.0 / t, sys.cap_tok_s)

    def retire(self) -> int:
        """Finish this sequence: drain in-flight readback, then free every
        page and the tier namespace.  Returns the tier keys freed."""
        self.flush_io()
        return self.pool.release()
