"""Serving engine with TRACE-tiered KV offload.

End-to-end path (paper Fig. 1/6 on a GPU host):

  prefill  — one forward over the prompt fills the KV cache on the card;
             completed pages (windows of ``page_tokens``) of the stacked
             layers' paged kinds (``k`` / ``v``, or MLA's ``c_kv``
             latent) are copied to the host and committed to the
             ``KVPagePool`` as BF16 token-major streams (the CXL.mem
             write stream of the paper).  MLA's ``k_rope`` and the
             ``dense0`` layers' cache stay on the card, as in the
             reference.
  decode   — one-token steps attend through the decode-attention kernel
             over the cache, whose spilled pages were overwritten in place
             with the tier's readback at their policy precision.  The
             step's position is a 0-d int32 tensor on the device, as the
             reference's ``jax.jit(decode_step)`` traces it, so on a card
             each engine captures its decode step once in a CUDA graph
             (at its first decode) and replays it every token; on the CPU
             the same step runs eagerly.  Prefill stays eager, with a host
             position: a graph replays only the shape it captured, and
             each prompt length would need a capture for one use.
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

Shared-prefix reuse (``prefix_index``): the first prefill hashes the
prompt's full windows (:func:`prefix_chain_hashes`), and every completed
window wholly inside the prompt is committed with its hash, so identical
prompt prefixes are stored once on the tier (see ``paging.py``).

Multi-stream serving: :class:`MultiStreamEngine` runs N sequences whose
pools share ONE tier under per-stream key namespaces, decoding
round-robin; their readback tickets coalesce in the shared in-flight
window.

Continuous batching: :class:`ServeScheduler` adds request arrival and
departure on top of that sharing — requests from a trace
(:func:`repro_torch.core.synth.request_trace`) wait FIFO for a batch
slot and for KV capacity, prefill on admission, decode round-robin with
whoever else is active, and retire at the boundary of their last token,
freeing their pages and tier namespace (:meth:`ServeEngine.retire`).
Each request's tokens equal a solo :meth:`ServeEngine.generate` of it.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import devices
from ..configs.base import ArchConfig
from ..core.system_model import SystemSpec
from ..core.tier import Ticket, TierStore, make_device
from ..kernels import build
from ..models.model import cache_capacity, cache_spec, decode_step, init_cache
from .paging import (
    KVPagePool, PagePolicy, PAPER_POLICY, PrefixShareIndex, _Page,
    prefix_chain_hashes,
)


# KV kinds the tier pages, in commit order; the key-bearing ones carry
# the attention masses (V pages take their K twin's).  An SSM or hybrid
# cache (conv / ssm state, the hybrid's rolling attn_k / attn_v) holds
# none of them, so it pages nothing, as in the reference.
PAGED_KINDS = ("k", "v", "c_kv")
KEY_KINDS = ("k", "c_kv")


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


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


class DecodeGraph:
    """One engine's decode step captured in a CUDA graph and replayed at
    every token: static ``tokens`` (B, 1) int64 and ``pos`` (0-d int32)
    in, static ``logits`` (B, 1, vocab) out, the engine's cache written in
    place.  Capture: a warm-up step on a copy of the cache, on the side
    stream the capture then uses (it builds and loads the kernels,
    allocates decode attention's merge counters, which are kept per
    stream, and initialises the libraries, none of which a capture may
    do), then ``decode_step`` captured with ``torch.cuda.graph``.  The
    kernel
    launches its wrappers counted while it was captured did not run:
    they are taken back, and :meth:`replay` adds them to
    ``build.LAUNCHES`` each time it launches them.  A failed capture or
    replay raises; nothing falls back to the eager step."""

    def __init__(self, cfg: ArchConfig, params, cache: dict,
                 tokens: torch.Tensor, pos: int):
        dev = tokens.device
        self.tokens = tokens.to(torch.int64).clone()
        self.pos = torch.full((), pos, dtype=torch.int32, device=dev)
        batch = {"tokens": self.tokens, "cache_pos": self.pos}
        stream = torch.cuda.Stream(dev)
        t0 = time.perf_counter()
        scratch = _clone_tree(cache)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            decode_step(cfg, params, batch, scratch)
        torch.cuda.current_stream(dev).wait_stream(stream)
        del scratch
        t1 = time.perf_counter()
        before = dict(build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits, _ = decode_step(cfg, params, batch, cache)
        self.launches = {k: n - before[k] for k, n in build.LAUNCHES.items()
                         if n != before[k]}
        build.LAUNCHES.update(before)
        # host seconds of the warm-up step and of the capture
        self.warmup_s = t1 - t0
        self.capture_s = time.perf_counter() - t1

    def replay(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """The step's logits at ``pos`` for ``tokens``: the static inputs
        filled, the graph replayed on the current stream."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        for name, n in self.launches.items():
            build.LAUNCHES[name] += n
        return self.logits


def check_servable(cfg: ArchConfig):
    """Raise ``ValueError`` for a model the engine cannot serve: an
    encoder-only one (no decode step) or one fed ``embeds`` by a modality
    frontend (the engine feeds token ids; the reference's engine cannot
    serve one either).  ``models.model.forward`` runs both."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                         "step to serve; run it with models.model.forward")
    if not cfg.uses_tokens:
        raise ValueError(f"{cfg.name} takes {cfg.frontend} frontend embeds, "
                         "not tokens: the serving engine feeds token ids; "
                         "run it with models.model.forward / decode_step")


class ServeEngine:
    """Single-host serving of one model with paged, tiered KV, on
    ``device`` (default: the card).  ``params`` must live there.
    ``device_kind`` is the tier (a kind, built with ``sanitize``, or a
    :class:`TierStore` / fleet); ``prefix_index`` must be built on it."""

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
        sanitize: Optional[bool] = None,
        prefix_index: Optional[PrefixShareIndex] = None,
        pnm_topk: Optional[int] = None,
        importance: str = "recency",
        device: Union[str, torch.device, None] = None,
    ):
        check_servable(cfg)
        if importance not in ("recency", "attention"):
            raise ValueError(f"unknown importance mode {importance!r}")
        if pnm_topk is not None and pnm_topk < 0:
            raise ValueError("pnm_topk must be >= 0 (or None to disable)")
        self.device = devices.resolve(device)
        where = params["final_norm"]["scale"].device
        if where != self.device:
            raise ValueError(f"params live on {where}, engine on "
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
            key_prefix=key_prefix, sanitize=sanitize,
            prefix_index=prefix_index, device=self.device,
        )
        self.cache = init_cache(cfg, batch, max_seq, device=self.device)
        self.pos = 0
        # the captured decode step (a card), made at the first decode
        self.graph: Optional[DecodeGraph] = None
        # prompt-prefix chain hashes, set by the first prefill when the
        # pool is wired to a PrefixShareIndex
        self._share_hashes: List[str] = []
        self._prompt_len = 0
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
        kinds = [k for k in PAGED_KINDS if k in layers]
        batch_pages = []
        for start in range(lo - lo % self.page_tokens, hi, self.page_tokens):
            if start + self.page_tokens > hi:
                break
            # a window wholly inside the prompt carries its prefix chain
            # hash (identical prompt prefixes give identical KV there);
            # windows touching generated tokens stay private
            share = None
            if (self._share_hashes
                    and start + self.page_tokens <= self._prompt_len):
                share = self._share_hashes[start // self.page_tokens]
            for kind in kinds:
                win = layers[kind][:, :, start : start + self.page_tokens]
                # (L, B, page, channels...) → host, as 16-bit words
                host = win.cpu().contiguous().view(torch.int16).numpy()
                for layer in range(host.shape[0]):
                    tok = host[layer].reshape(self.page_tokens * self.batch, -1)
                    batch_pages.append((layer, kind, start,
                                        tok.view(np.uint16), float(start),
                                        share))
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
        buf = self.cache["layers"][kind]         # (L, B, S, channels...)
        channels = int(np.prod(buf.shape[3:]))
        win = buf[:, :, max(0, self.pos - self.page_tokens):self.pos]
        if win.numel() == 0:
            return torch.zeros(channels, dtype=torch.float32,
                               device=buf.device)
        return win.float().reshape(-1, channels).mean(dim=0)

    def _attention_masses(self) -> Dict[Tuple[str, int, int], float]:
        """Digest-proxy attention mass per committed window of each
        key-bearing kind (``k`` / ``c_kv``), keyed by ``(kind, layer,
        start)``: every committed row's ``<row, digest>`` is softmaxed
        across the layer's whole committed context (all batch rows
        together), and a window's mass is the sum of its rows'
        probabilities.  Computed on the engine's device; one float per
        window goes to the host."""
        page = self.page_tokens
        paged = (self.pos // page) * page
        if paged <= 0:
            return {}
        masses = {}
        layers = self.cache["layers"]
        for kind in (k for k in KEY_KINDS if k in layers):
            buf = layers[kind]
            L, B = buf.shape[:2]
            rows = buf[:, :, :paged].float().reshape(L, B * paged, -1)
            dots = rows @ self._digest(kind)           # (L, B * paged)
            p = torch.exp(dots - dots.amax(dim=1, keepdim=True))
            p = p / p.sum(dim=1, keepdim=True)
            win = p.reshape(L, B, paged // page, page).sum(dim=(1, 3))
            win = win.cpu().numpy()
            masses.update({(kind, layer, w * page): float(win[layer, w])
                           for layer in range(L)
                           for w in range(paged // page)})
        return masses

    def _apply_attention_importance(self, batch_pages: List[tuple]
                                    ) -> List[tuple]:
        """Fold this boundary's attention masses into the per-key running
        totals, re-rank the pool's live pages by them, and admit the
        fresh pages at their accumulated mass instead of recency.  V pages
        take their K twin's mass."""
        masses = self._attention_masses()
        if not masses:
            return batch_pages

        def mass(kind, layer, start):
            return masses.get(("k" if kind == "v" else kind, layer, start))

        for p in self.pool.iter_pages():
            m = mass(p.kind, p.layer, p.start)
            if m is not None:
                self._imp_acc[p.key] = self._imp_acc.get(p.key, 0.0) + m
        known = {p.key for p in self.pool.iter_pages()}
        scores = {k: v for k, v in self._imp_acc.items() if k in known}
        if scores:
            self.pool.update_importance(scores)
        out = []
        for layer, kind, start, u16, imp, share in batch_pages:
            key = self.pool.page_key(layer, kind, start, share)
            m = mass(kind, layer, start)
            if m is not None:
                self._imp_acc[key] = self._imp_acc.get(key, 0.0) + m
                imp = self._imp_acc[key]
            out.append((layer, kind, start, u16, imp, share))
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
    def _prefill_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """The prompt's logits, eagerly, at the host position."""
        return decode_step(self.cfg, self.params, {
            "tokens": tokens, "cache_pos": self.pos}, self.cache)[0]

    def _decode_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """One token's logits with the position on the device: on a card
        a replay of the captured step (captured at the first decode), on
        the CPU the same step run eagerly."""
        if self.device.type != "cuda":
            return decode_step(self.cfg, self.params, {
                "tokens": tokens, "cache_pos": torch.tensor(
                    self.pos, dtype=torch.int32, device=self.device)},
                self.cache)[0]
        if self.graph is None:
            self.graph = DecodeGraph(self.cfg, self.params, self.cache,
                                     tokens, self.pos)
        return self.graph.replay(tokens, self.pos)

    def _step(self, tokens: np.ndarray, run) -> np.ndarray:
        n = tokens.shape[1]
        cap = cache_capacity(self.cache)
        if cap is not None and self.pos + n > cap:
            raise ValueError(f"{n} tokens at position {self.pos} pass the "
                             f"cache's {cap} slots (max_seq)")
        logits = run(torch.from_numpy(np.ascontiguousarray(
            tokens, dtype=np.int64)).to(self.device))
        old = self.pos
        self.pos += n
        self._commit_pages(old, self.pos)
        return logits[:, -1].float().cpu().numpy()

    def prefill(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (batch, prompt_len) → last-token logits (f32)."""
        assert tokens.shape[0] == self.batch
        if self.pos == 0 and self.pool.prefix_index is not None:
            self._share_hashes = prefix_chain_hashes(tokens, self.page_tokens)
            self._prompt_len = tokens.shape[1]
        return self._step(tokens, self._prefill_logits)

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (batch, 1) current token → next-token logits (f32)."""
        return self._step(tokens.reshape(self.batch, 1), self._decode_logits)

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

    # -- KV readback through the tier (quality measurement path) ---------------
    def kv_through_tier(self, layer: int, kind: str = "k") -> np.ndarray:
        """Token-major KV of (layer, kind) as the host sees it after a
        round trip through the tier at the current policy."""
        self.flush_io()
        return self.pool.read_layer(layer, kind)

    def layer_traffic(self):
        """Per-layer tier traffic, attributed from the pool's receipts."""
        self.flush_io()
        return self.pool.traffic_by_layer()

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
        page and the tier namespace (and the captured step's graph).
        Returns the tier keys freed."""
        self.flush_io()
        self.graph = None
        return self.pool.release()


class MultiStreamEngine:
    """N independent sequences sharing one tier device queue.

    Each stream is a full :class:`ServeEngine` (own cache, pool and HBM
    budget) on ``device`` (default: the card); all pools write and read
    through one tier (``device_kind``: a kind, built with ``shards``,
    ``placement`` and ``sanitize``, or a :class:`TierStore` / fleet) under
    per-stream key prefixes ``s{i}.``.  Decode goes round-robin one token
    at a time, so each round's readback tickets accumulate in the shared
    in-flight window and the first stream to reach its next boundary
    drains them as one cross-stream group.  Per-key program order keeps
    every stream's tokens equal to its solo run.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        n_streams: int,
        *,
        device_kind: Union[str, TierStore] = "trace",
        async_io: bool = True,
        sanitize: Optional[bool] = None,
        shards: Optional[int] = None,
        placement: Optional[str] = None,
        device: Union[str, torch.device, None] = None,
        **engine_kw,
    ):
        self.device = devices.resolve(device)
        self.tier = (make_device(device_kind, shards=shards,
                                 placement=placement, sanitize=sanitize,
                                 device=self.device)
                     if isinstance(device_kind, str) else device_kind)
        self.streams = [
            ServeEngine(cfg, params, device_kind=self.tier,
                        key_prefix=f"s{i}.", async_io=async_io,
                        device=self.device, **engine_kw)
            for i in range(n_streams)
        ]

    def generate(self, prompts: Sequence[np.ndarray], n_tokens: int,
                 greedy: bool = True, seed: int = 0) -> List[np.ndarray]:
        """Round-robin generation; ``prompts[i]`` is stream *i*'s (batch,
        prompt_len) tokens, sampled with seed ``seed + i``.  Returns
        per-stream (batch, n_tokens) arrays."""
        assert len(prompts) == len(self.streams)
        rngs = [np.random.default_rng(seed + i) for i in range(len(prompts))]
        logits = [eng.prefill(p) for eng, p in zip(self.streams, prompts)]
        outs: List[List[np.ndarray]] = [[] for _ in self.streams]
        for _ in range(n_tokens):
            for i, eng in enumerate(self.streams):
                nxt = _sample_next(logits[i], rngs[i], greedy)
                outs[i].append(nxt)
                logits[i] = eng.decode(nxt.reshape(-1, 1))
        return [np.stack(o, axis=1) for o in outs]

    def flush_io(self):
        for eng in self.streams:
            eng.flush_io()

    def stats(self) -> List[ServeStats]:
        """Per-stream stats (shared-tier aggregates are identical)."""
        return [eng.stats() for eng in self.streams]

    def device_stats(self):
        """The shared tier's stats, after draining every stream."""
        self.flush_io()
        return self.tier.stats

    def throughput_ceiling(self, sys: SystemSpec = SystemSpec()) -> float:
        """Aggregate tok/s ceiling across streams on the shared tier."""
        d = self.device_stats()
        steps = max(sum(eng.pos for eng in self.streams), 1)
        t = max(d.dram_bytes_read / steps / sys.cxl_ddr_bw,
                d.link_bytes_out / steps / sys.cxl_link_bw, 1e-12)
        return min(1.0 / t, sys.cap_tok_s)

    def retire(self) -> int:
        """Retire every stream (see :meth:`ServeEngine.retire`)."""
        return sum(eng.retire() for eng in self.streams)


# ---------------------------------------------------------------------------
# Continuous batching — request arrival/departure over one shared tier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One request: ``arrival`` in scheduler decode rounds, ``prompt``
    ``(batch, prompt_len)`` int32, and the ``seed`` of the sampling rng a
    solo :meth:`ServeEngine.generate` would use."""

    req_id: int
    arrival: float
    prompt: np.ndarray
    max_new_tokens: int
    greedy: bool = True
    seed: int = 0


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle record of one request: steps are scheduler ticks,
    ``t_*_s`` stamps modeled seconds; ``tokens`` is set at retirement."""

    req_id: int
    arrival: float
    kv_projected_bytes: int = 0
    kv_novel_bytes: int = -1    # admission charge after the shared-prefix
                                # discount (-1 until admission computes it)
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    t_arrive_s: float = -1.0
    t_admit_s: float = -1.0
    t_first_token_s: float = -1.0
    t_finish_s: float = -1.0
    prefill_tokens: int = 0
    tokens: Optional[np.ndarray] = None

    @property
    def finished(self) -> bool:
        return self.tokens is not None

    @property
    def kv_charged_bytes(self) -> int:
        """What admission charged against the capacity (and retirement
        refunds): the novel-KV projection when computed, else the full
        projection."""
        return (self.kv_novel_bytes if self.kv_novel_bytes >= 0
                else self.kv_projected_bytes)

    @property
    def queue_delay_s(self) -> float:
        """Arrival → admission wait."""
        return self.t_admit_s - self.t_arrive_s

    @property
    def latency_s(self) -> float:
        """Arrival → last generated token."""
        return self.t_finish_s - self.t_arrive_s

    @property
    def ttft_s(self) -> float:
        """Arrival → the tick that produced the first token."""
        return self.t_first_token_s - self.t_arrive_s

    @property
    def tpot_s(self) -> float:
        """Mean gap between tokens after the first; NaN for one token."""
        if self.tokens is None or self.tokens.shape[1] <= 1:
            return float("nan")
        return ((self.t_finish_s - self.t_first_token_s)
                / (self.tokens.shape[1] - 1))


@functools.lru_cache(maxsize=32)
def _kv_bytes_per_token_b1(cfg: ArchConfig) -> int:
    """Paged-KV bytes one committed token adds at batch 1, from the
    cache's shapes (nothing allocated): every paged kind of the stacked
    layers, counted at 2 bytes an element whatever ``kv_dtype`` is, as
    the reference counts them.  One cache entry per architecture."""
    layers = cache_spec(cfg, 1, 8)["layers"]
    return sum(leaf.shape[0] * int(np.prod(leaf.shape[3:])) * 2
               for kind, leaf in layers.items() if kind in PAGED_KINDS)


def _kv_bytes_per_token(cfg: ArchConfig, batch: int) -> int:
    """Paged-KV bytes one committed token adds at ``batch`` (exactly
    linear in batch)."""
    return _kv_bytes_per_token_b1(cfg) * batch


def projected_kv_bytes(cfg: ArchConfig, batch: int, total_tokens: int,
                       page_tokens: int,
                       per_token: Optional[int] = None) -> int:
    """Logical BF16 bytes of paged KV a ``total_tokens`` sequence commits:
    completed page windows only (a partial tail never reaches the pool)
    times the per-token increment (``per_token`` if given)."""
    paged = (total_tokens // page_tokens) * page_tokens
    if paged <= 0:
        return 0
    if per_token is None:
        per_token = _kv_bytes_per_token(cfg, batch)
    return paged * per_token


class _ActiveSeq:
    """One admitted request: its engine, sampling rng and progress."""

    __slots__ = ("req", "record", "engine", "rng", "logits", "out", "done")

    def __init__(self, req: ServeRequest, record: RequestRecord,
                 engine: ServeEngine, rng: np.random.Generator,
                 logits: np.ndarray):
        self.req = req
        self.record = record
        self.engine = engine
        self.rng = rng
        self.logits = logits
        self.out: List[np.ndarray] = []
        self.done = False


@dataclasses.dataclass
class SchedulerReport:
    """End-of-run roll-up: finished records and modeled aggregates.
    Percentiles and means are NaN on an empty denominator."""

    records: List[RequestRecord]
    steps: int
    model_time_s: float
    decode_tokens: int
    prefill_tokens: int
    peak_active: int = 0
    capacity_model: str = "logical"
    kv_ratio_estimate: float = 1.0
    reclaimed_bytes: int = 0
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None
    n_devices: int = 1
    fleet_skew: float = 1.0

    @property
    def slo_attainment(self) -> float:
        """Fraction of finished requests meeting every configured SLO (an
        unset target is met; a NaN TPOT never violates).  NaN with no SLO
        or nothing finished."""
        if self.slo_ttft_s is None and self.slo_tpot_s is None:
            return float("nan")
        done = [r for r in self.records if r.finished]
        if not done:
            return float("nan")
        ok = 0
        for r in done:
            if (self.slo_ttft_s is not None
                    and not r.ttft_s <= self.slo_ttft_s):
                continue
            if (self.slo_tpot_s is not None and np.isfinite(r.tpot_s)
                    and not r.tpot_s <= self.slo_tpot_s):
                continue
            ok += 1
        return ok / len(done)

    @property
    def tok_s(self) -> float:
        """Generated tokens over the modeled run time."""
        return self.decode_tokens / max(self.model_time_s, 1e-12)

    def latency_percentile(self, q: float) -> float:
        lats = [r.latency_s for r in self.records if r.finished]
        return float(np.percentile(lats, q)) if lats else float("nan")

    @property
    def p50_latency_s(self) -> float:
        return self.latency_percentile(50)

    @property
    def p99_latency_s(self) -> float:
        return self.latency_percentile(99)

    @property
    def mean_queue_delay_s(self) -> float:
        qs = [r.queue_delay_s for r in self.records if r.finished]
        return float(np.mean(qs)) if qs else float("nan")

    def ttft_percentile(self, q: float) -> float:
        ts = [r.ttft_s for r in self.records if r.finished]
        return float(np.percentile(ts, q)) if ts else float("nan")

    @property
    def p50_ttft_s(self) -> float:
        return self.ttft_percentile(50)

    @property
    def p99_ttft_s(self) -> float:
        return self.ttft_percentile(99)

    @property
    def mean_tpot_s(self) -> float:
        """Mean TPOT over finished multi-token requests (NaN if none)."""
        ts = [r.tpot_s for r in self.records
              if r.finished and np.isfinite(r.tpot_s)]
        return float(np.mean(ts)) if ts else float("nan")


class ServeScheduler:
    """Continuous-batching request scheduler over one shared tier.

    Requests wait FIFO for one of ``max_batch`` slots, run as a full
    :class:`ServeEngine` on ``device`` (default: the card) under the key
    namespace ``r{id}.``, and retire at the tick that produced their last
    token, freeing HBM pages and their tier namespace.  All engines share
    one tier (``device_kind``; ``shards`` > 1 builds a fleet), so their
    spills and readbacks coalesce.

    Admission: with ``kv_capacity_bytes`` a request joins only when the
    KV projections of the active requests plus its own fit; a blocked
    head of line is never bypassed, and an empty batch admits anything
    (no deadlock).  ``capacity_model="logical"`` compares raw BF16
    projections; ``"physical"`` divides them by a running estimate of
    the tier's compression ratio, corrected against the residency ledger
    every tick.  A ``degrade_ladder`` (physical model only) lets a
    blocked admission :meth:`KVPagePool.reclaim` stored bytes of the
    active pools before it stalls.  ``prefix_share`` wires every engine
    to one :class:`PrefixShareIndex` and charges each admission only its
    novel KV.

    Modeled time: a tick costs ``max(1/cap_tok_s, tier I/O time)``,
    the I/O time being the slowest tier device's byte delta over its own
    DDR and link rates.  Tokens equal solo runs at the same ``max_seq``.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        max_batch: int = 4,
        device_kind: Union[str, TierStore] = "trace",
        policy: Optional[PagePolicy] = None,
        batch: int = 1,
        page_tokens: int = 16,
        hbm_kv_budget: int = 1 << 12,
        max_seq: Optional[int] = None,
        kv_capacity_bytes: Optional[int] = None,
        capacity_model: str = "logical",
        degrade_ladder: Optional[Sequence] = None,
        async_io: bool = True,
        sys: SystemSpec = SystemSpec(),
        sanitize: Optional[bool] = None,
        prefix_share: bool = False,
        slo_ttft_s: Optional[float] = None,
        slo_tpot_s: Optional[float] = None,
        shards: Optional[int] = None,
        placement: Optional[str] = None,
        pnm_topk: Optional[int] = None,
        importance: str = "recency",
        device: Union[str, torch.device, None] = None,
    ):
        if capacity_model not in ("logical", "physical"):
            raise ValueError(f"unknown capacity model {capacity_model!r}")
        if degrade_ladder and capacity_model != "physical":
            # reclaim frees stored bytes, which logical admission never
            # looks at: a ladder could only destroy precision
            raise ValueError(
                "degrade_ladder requires capacity_model='physical'")
        check_servable(cfg)
        self.cfg = cfg
        self.params = params
        self.device = devices.resolve(device)
        self.tier = (make_device(device_kind, shards=shards,
                                 placement=placement, sanitize=sanitize,
                                 device=self.device)
                     if isinstance(device_kind, str) else device_kind)
        self.max_batch = max_batch
        self.policy = PAPER_POLICY if policy is None else policy
        self.batch = batch
        self.page_tokens = page_tokens
        self.hbm_kv_budget = hbm_kv_budget
        self.kv_capacity_bytes = kv_capacity_bytes
        self.capacity_model = capacity_model
        self.degrade_ladder = tuple(degrade_ladder or ())
        self.async_io = async_io
        self.sys = sys
        self.slo_ttft_s = slo_ttft_s      # reported, never gated on
        self.slo_tpot_s = slo_tpot_s
        self.pnm_topk = pnm_topk
        self.importance = importance
        self.prefix_index = (PrefixShareIndex(self.tier)
                             if prefix_share else None)
        self._max_seq = max_seq
        self.pending: List[ServeRequest] = []
        self.active: List[Optional[_ActiveSeq]] = [None] * max_batch
        self.records: Dict[int, RequestRecord] = {}
        self.clock = 0                  # scheduler ticks (decode rounds)
        self.model_time_s = 0.0
        self.kv_committed_bytes = 0     # charges of the active requests
        self.peak_active = 0
        self.reclaimed_bytes = 0
        # admission's compression-ratio estimate: neutral until the tier
        # stores bytes, then corrected every tick (see _update_ratio)
        self.kv_ratio_estimate = 1.0
        self._ratio_seeded = False
        self._ledger_mark = (0, 0)      # (raw, physical) at last correction
        self._kv_per_token: Optional[int] = None
        self._first_this_tick: List[RequestRecord] = []
        self._next_id = 0
        self._io_mark = self._io_snapshot()

    @property
    def max_seq(self) -> Optional[int]:
        """Largest sequence budget a submitted request has needed so far
        (``None`` before the first)."""
        return self._max_seq

    # -- request intake ------------------------------------------------------
    def submit(self, requests: Sequence[Union[ServeRequest, dict]]):
        """Queue requests (``ServeRequest`` s or ``request_trace`` dicts,
        which get the next free ids), kept sorted by (arrival, id)."""
        for r in requests:
            if isinstance(r, dict):
                r = ServeRequest(req_id=self._next_id, **r)
            self._next_id = max(self._next_id, r.req_id + 1)
            if r.max_new_tokens < 1:
                raise ValueError("requests must generate at least one token")
            if r.prompt.shape[0] != self.batch:
                raise ValueError(
                    f"prompt batch {r.prompt.shape[0]} != scheduler batch "
                    f"{self.batch}")
            if r.req_id in self.records:
                raise ValueError(f"duplicate req_id {r.req_id}")
            total = r.prompt.shape[-1] + r.max_new_tokens
            need = total + self.page_tokens
            if self._max_seq is None or self._max_seq < need:
                self._max_seq = need
            if self._kv_per_token is None:
                self._kv_per_token = _kv_bytes_per_token(self.cfg, self.batch)
            self.records[r.req_id] = RequestRecord(
                req_id=r.req_id, arrival=r.arrival,
                kv_projected_bytes=projected_kv_bytes(
                    self.cfg, self.batch, total, self.page_tokens,
                    per_token=self._kv_per_token),
            )
            self.pending.append(r)
        self.pending.sort(key=lambda r: (r.arrival, r.req_id))

    # -- one scheduler tick --------------------------------------------------
    def step(self) -> bool:
        """One tick: admit arrivals into free slots, decode one token of
        every active sequence, tear down the finished ones' engines,
        advance the modeled clock, retire.  Returns True while requests
        are queued or active."""
        self._admit()
        self.peak_active = max(self.peak_active, self.n_active)
        self._decode_round()
        for seq in self.active:
            if seq is not None and seq.done:
                seq.engine.retire()     # priced into this tick
        self._advance_time()
        # TTFT includes the round that produced the token
        for rec in self._first_this_tick:
            rec.first_token_step = self.clock
            rec.t_first_token_s = self.model_time_s
        self._first_this_tick.clear()
        self._update_ratio()
        self._retire()
        self.clock += 1
        return bool(self.pending or any(s is not None for s in self.active))

    def run(self, requests: Optional[Sequence] = None,
            max_steps: int = 1_000_000) -> SchedulerReport:
        """Drive :meth:`step` until every submitted request has retired."""
        if requests:
            self.submit(requests)
        while self.step():
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("scheduler failed to drain")
        return self.report()

    def report(self) -> SchedulerReport:
        done = [self.records[k] for k in sorted(self.records)
                if self.records[k].finished]
        return SchedulerReport(
            records=done,
            steps=self.clock,
            model_time_s=self.model_time_s,
            decode_tokens=sum(r.tokens.size for r in done),
            prefill_tokens=sum(r.prefill_tokens for r in done),
            peak_active=self.peak_active,
            capacity_model=self.capacity_model,
            kv_ratio_estimate=self.kv_ratio_estimate,
            reclaimed_bytes=self.reclaimed_bytes,
            slo_ttft_s=self.slo_ttft_s,
            slo_tpot_s=self.slo_tpot_s,
            n_devices=len(self._device_stat_list()),
            fleet_skew=getattr(self.tier, "fleet_skew", lambda: 1.0)(),
        )

    # -- internals -----------------------------------------------------------
    def _device_stat_list(self):
        """Per-device stats: one entry for a single tier, one a shard
        for a fleet (whose tick I/O time is its slowest shard's)."""
        per = getattr(self.tier, "per_device_stats", None)
        return per() if per is not None else [self.tier.stats]

    def _io_snapshot(self):
        return [(d.dram_bytes_read + d.dram_bytes_written,
                 d.link_bytes_in + d.link_bytes_out)
                for d in self._device_stat_list()]

    def _projected_physical(self, logical_bytes: int) -> int:
        """A logical projection in the bytes the tier is expected to
        store for it under the current ratio estimate."""
        if self.capacity_model == "logical":
            return logical_bytes
        return int(np.ceil(logical_bytes
                           / max(self.kv_ratio_estimate, 1e-6)))

    def _novel_bytes(self, req: ServeRequest, rec: RequestRecord) -> int:
        """The admission charge: the request's projection less its
        leading prompt windows whose shared pages are already stored.
        Recomputed at each attempt, frozen into the record at admission
        so retirement refunds exactly the charge."""
        if self.prefix_index is None:
            return rec.kv_projected_bytes
        hashes = prefix_chain_hashes(req.prompt, self.page_tokens)
        hit_windows = self.prefix_index.resident_chain(hashes)
        shared = hit_windows * self.page_tokens * (self._kv_per_token or 0)
        return max(rec.kv_projected_bytes - shared, 0)

    def _kv_fits(self, rec: RequestRecord) -> bool:
        if self.kv_capacity_bytes is None:
            return True
        if not any(s is not None for s in self.active):
            return True                  # empty-batch escape (no deadlock)
        need = self.kv_committed_bytes + rec.kv_charged_bytes
        return self._projected_physical(need) <= self.kv_capacity_bytes

    def _update_ratio(self):
        """Correct the ratio estimate against the residency ledger: the
        ratio of the bytes stored since the last correction, else of all
        stored bytes when the tick freed bytes or stored none."""
        raw = self.tier.stats.raw_bytes_stored
        phys = self.tier.resident_bytes()
        d_raw = raw - self._ledger_mark[0]
        d_phys = phys - self._ledger_mark[1]
        self._ledger_mark = (raw, phys)
        if d_raw > 0 and d_phys > 0:
            obs = d_raw / d_phys
        elif raw > 0 and phys > 0:
            obs = raw / phys
        else:
            return                       # tier empty: keep the estimate
        if not self._ratio_seeded:
            self.kv_ratio_estimate = obs  # the neutral 1.0 was no reading
            self._ratio_seeded = True
        else:
            self.kv_ratio_estimate += 0.5 * (obs - self.kv_ratio_estimate)

    def _reclaim_for(self, rec: RequestRecord) -> bool:
        """Blocked admission: shed cold stored planes across the active
        pools toward the head of line's deficit, then re-check the fit
        (through the corrected ratio).  True when that unblocked it."""
        if not self.degrade_ladder or self.capacity_model != "physical":
            return False
        need = self.kv_committed_bytes + rec.kv_charged_bytes
        deficit = self._projected_physical(need) - self.kv_capacity_bytes
        freed = 0
        for seq in self.active:
            if seq is None or freed >= deficit:
                continue
            freed += seq.engine.pool.reclaim(deficit - freed,
                                             self.degrade_ladder)
        if freed == 0:
            return False
        self.reclaimed_bytes += freed
        self._update_ratio()             # the ledger just shrank
        return self._kv_fits(rec)

    def _admit(self):
        # stamp every delivered request: queue delay starts at arrival
        for r in self.pending:
            if r.arrival > self.clock:
                break
            rec = self.records[r.req_id]
            if rec.t_arrive_s < 0:
                rec.t_arrive_s = self.model_time_s
        free = [i for i, s in enumerate(self.active) if s is None]
        while free and self.pending and self.pending[0].arrival <= self.clock:
            req = self.pending[0]
            rec = self.records[req.req_id]
            rec.kv_novel_bytes = self._novel_bytes(req, rec)
            if not self._kv_fits(rec) and not self._reclaim_for(rec):
                break                    # strict FIFO: wait for retirements
            self.pending.pop(0)
            self.kv_committed_bytes += rec.kv_charged_bytes
            self.active[free.pop(0)] = self._start(req, rec)

    def _start(self, req: ServeRequest, rec: RequestRecord) -> _ActiveSeq:
        eng = ServeEngine(
            self.cfg, self.params, max_seq=self._max_seq, batch=self.batch,
            page_tokens=self.page_tokens, hbm_kv_budget=self.hbm_kv_budget,
            device_kind=self.tier, policy=self.policy,
            key_prefix=f"r{req.req_id}.", async_io=self.async_io,
            prefix_index=self.prefix_index,
            pnm_topk=self.pnm_topk, importance=self.importance,
            device=self.device,
        )
        rec.admit_step = self.clock
        rec.t_admit_s = self.model_time_s
        rec.prefill_tokens = int(req.prompt.size)
        logits = eng.prefill(req.prompt)
        return _ActiveSeq(req, rec, eng,
                          np.random.default_rng(req.seed), logits)

    def _decode_round(self):
        for seq in self.active:
            if seq is None:
                continue
            nxt = _sample_next(seq.logits, seq.rng, seq.req.greedy)
            seq.out.append(nxt)
            if len(seq.out) == 1:
                self._first_this_tick.append(seq.record)
            if len(seq.out) < seq.req.max_new_tokens:
                seq.logits = seq.engine.decode(nxt.reshape(-1, 1))
            else:
                seq.done = True

    def _advance_time(self):
        """A tick costs the compute ceiling or the slowest tier device's
        tick I/O over its own DDR and link pipes, whichever is longer."""
        snap = self._io_snapshot()
        io_s = 0.0
        for (dram, link), (m_dram, m_link) in zip(snap, self._io_mark):
            io_s = max(io_s,
                       (dram - m_dram) / self.sys.cxl_ddr_bw,
                       (link - m_link) / self.sys.cxl_link_bw)
        self._io_mark = snap
        self.model_time_s += max(1.0 / self.sys.cap_tok_s, io_s)

    def _retire(self):
        """Record and free the finished sequences (their engines were
        torn down in :meth:`step`, before the tick's time advance)."""
        for i, seq in enumerate(self.active):
            if seq is None or not seq.done:
                continue
            rec = seq.record
            rec.tokens = np.stack(seq.out, axis=1)
            rec.finish_step = self.clock
            rec.t_finish_s = self.model_time_s
            self.kv_committed_bytes -= rec.kv_charged_bytes
            self.active[i] = None

    # -- introspection -------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.active)

    def device_stats(self):
        """The shared tier's stats."""
        return self.tier.stats
