"""Serving entry point: generation with TRACE-tiered KV offload, on the card.

Serves ``--requests`` requests one after another through a
:class:`ServeEngine` at full model width (``--smoke`` reduces it), each
request on its own key namespace of one shared tier device and retired
when done.  Reports tier traffic, the KV compression ratio, the implied
tok/s ceiling and the wall-clock rate.  ``--streams N`` serves each
request as N sequences decoding round-robin on one tier queue
(:class:`MultiStreamEngine`).

``--num-requests N`` switches to continuous batching
(:class:`ServeScheduler`): a synthetic trace of N requests (Poisson or
bursty arrivals at ``--arrival-rate`` a decode round) waits FIFO for
``--max-batch`` slots and ``--kv-capacity`` bytes of KV (under the
``--capacity-model``), optionally reclaiming stored bytes by the
``--degrade-ladder`` and sharing prompt-prefix pages (``--prefix-share``,
with ``--share-prefix-len`` common leading tokens); it reports modeled
throughput, latency and TTFT/TPOT percentiles.

``--pnm-topk K`` turns spill readback into a device-side top-K gather per
KV kind per boundary (K covering the spill reads back exactly what the
classic path does); ``--importance attention`` ranks pages by
accumulated attention mass instead of commit recency; ``--shards N``
(with ``--placement P``) serves against a fleet of N tier devices.

Usage (on a machine with an NVIDIA GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --prompt-len 512 --tokens 64 --requests 3
  PYTHONPATH=src python -m repro_torch.launch.serve --prompt-len 512 \\
      --tokens 64 --requests 1 --pnm-topk 16 --importance attention \\
      --shards 4 --placement hash-stripe
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --cpu \\
      --prompt-len 64 --tokens 8 --hbm-kv-budget 16384
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --cpu \\
      --num-requests 6 --arrival-rate 0.5 --prompt-len 64 --tokens 8 \\
      --hbm-kv-budget 16384 --prefix-share --share-prefix-len 32 \\
      --kv-capacity 40000 --capacity-model physical --degrade-ladder default
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import devices
from ..configs import ARCHS, smoke_config
from ..core import synth
from ..core.precision import VIEWS
from ..core.tier import make_device
from ..models.model import init_params
from ..runtime import (
    DEFAULT_DEGRADE_LADDER, LOSSLESS_POLICY, PAPER_POLICY, MultiStreamEngine,
    ServeEngine, ServeScheduler,
)


def parse_degrade_ladder(spec: str):
    """CLI ladder spec → tuple of PrecisionViews: ``"none"`` / empty
    disables reclamation, ``"default"`` is man4 → man2 → man0, otherwise a
    comma-separated list of view names from ``core.precision.VIEWS``."""
    spec = (spec or "none").strip().lower()
    if spec in ("none", ""):
        return ()
    if spec == "default":
        return DEFAULT_DEGRADE_LADDER
    try:
        return tuple(VIEWS[name.strip()] for name in spec.split(","))
    except KeyError as e:
        raise SystemExit(
            f"unknown precision view {e.args[0]!r} in --degrade-ladder "
            f"(known: {', '.join(sorted(VIEWS))})")


@dataclasses.dataclass
class ServeReport:
    """What one :func:`serve` run did."""

    tokens: list                # (batch, n_tokens) per request
    generated_tokens: int
    wall_s: float               # prefill + decode of every request
    spilled_pages: int          # summed over requests
    readback_pages: int         # spilled pages read back into the cache
    gathered_pages: int         # winner pages the PNM gathers shipped
    kv_logical_bytes: int
    kv_stored_bytes: int        # tier payload + HBM pages, summed
    tier_dram_read: int
    tier_link_out: int
    tok_s_ceiling: float        # tier-bound model of the last request

    @property
    def tok_s(self) -> float:
        return self.generated_tokens / max(self.wall_s, 1e-12)

    @property
    def kv_compression_ratio(self) -> float:
        return self.kv_logical_bytes / max(self.kv_stored_bytes, 1)


def serve(
    arch: str = "qwen2-0.5b",
    smoke: bool = False,
    device: str = "trace",
    prompt_len: int = 512,
    n_tokens: int = 64,
    batch: int = 1,
    requests: int = 3,
    hbm_kv_budget: int = 1 << 22,
    page_tokens: int = 64,
    lossless_only: bool = False,
    streams: int = 1,
    async_io: bool = True,
    pnm_topk: Optional[int] = None,
    importance: str = "recency",
    shards: Optional[int] = None,
    placement: Optional[str] = None,
    sanitize: Optional[bool] = None,
    seed: int = 0,
    torch_device=None,
    params=None,
    verbose: bool = True,
) -> ServeReport:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens, ``n_tokens``
    new tokens each; with ``streams`` > 1 each request is ``streams``
    prompts decoding round-robin on one tier queue.  ``device`` names the
    tier kind (``shards`` > 1: a fleet of them under ``placement``);
    ``torch_device`` is where the model and kernels run (default: the
    card).  ``params`` overrides the seeded random init."""
    dev = devices.resolve(torch_device)
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_config(cfg)
    if params is None:
        params = init_params(cfg, seed=seed, device=dev)
    policy = LOSSLESS_POLICY if lossless_only else PAPER_POLICY
    tier = make_device(device, shards=shards, placement=placement,
                       sanitize=sanitize, device=dev)
    kw = dict(max_seq=prompt_len + n_tokens + page_tokens, batch=batch,
              page_tokens=page_tokens, hbm_kv_budget=hbm_kv_budget,
              device_kind=tier, policy=policy, async_io=async_io,
              pnm_topk=pnm_topk, importance=importance, device=dev)
    rng = np.random.default_rng(seed)
    toks, wall = [], 0.0
    spilled = readback = gathered = logical = stored = 0
    ceiling = 0.0
    for r in range(requests):
        if streams > 1:
            eng = MultiStreamEngine(cfg, params, streams, **kw)
            engines = eng.streams
        else:
            eng = ServeEngine(cfg, params, key_prefix=f"r{r}.", **kw)
            engines = [eng]
        prompts = [rng.integers(0, cfg.vocab, (batch, prompt_len))
                   .astype(np.int32) for _ in engines]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if streams > 1:
            toks.extend(eng.generate(prompts, n_tokens))
        else:
            toks.append(eng.generate(prompts[0], n_tokens))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall += time.perf_counter() - t0
        hbm = 0
        for e in engines:
            s = e.stats()
            spilled += s.spilled_pages
            readback += e.pool.pages_read
            gathered += e.pool.pages_gathered
            hbm += s.hbm_page_bytes
        # the tier holds this request's streams alone (earlier requests
        # retired), so its totals are theirs
        logical += tier.stats.raw_bytes_stored + hbm
        stored += tier.stats.dram_bytes_stored + hbm
        ceiling = eng.throughput_ceiling()
        eng.retire()
    d = tier.stats
    rep = ServeReport(
        tokens=toks, generated_tokens=len(toks) * batch * n_tokens,
        wall_s=wall,
        spilled_pages=spilled, readback_pages=readback,
        gathered_pages=gathered,
        kv_logical_bytes=logical, kv_stored_bytes=stored,
        tier_dram_read=d.dram_bytes_read, tier_link_out=d.link_bytes_out,
        tok_s_ceiling=ceiling,
    )
    if verbose:
        print(f"[serve] arch={cfg.name} layers={cfg.n_layers} "
              f"d_model={cfg.d_model} tier={device} on {dev} "
              f"async_io={async_io}: {requests} requests x "
              + (f"{streams} streams x " if streams > 1 else "")
              + f"{batch} x ({prompt_len} prompt + {n_tokens} new) tokens")
        if pnm_topk is not None:
            print(f"[serve] PNM read mode: top-{pnm_topk} gather per KV "
                  f"kind per boundary, importance={importance}")
        if getattr(tier, "n_shards", 1) > 1:
            print(f"[serve] fleet: {tier.n_shards} tier devices, placement "
                  f"{tier.placement.name}, skew {tier.fleet_skew():.3f}x "
                  "max/mean moved bytes")
        print(f"[serve] spilled pages {rep.spilled_pages}, read back "
              f"{rep.readback_pages}, gathered {rep.gathered_pages}; KV "
              f"{rep.kv_logical_bytes} B logical "
              f"stored in {rep.kv_stored_bytes} B "
              f"(ratio {rep.kv_compression_ratio:.3f}x)")
        print(f"[serve] tier DRAM read {rep.tier_dram_read} B, link out "
              f"{rep.tier_link_out} B; tok/s ceiling (tier-bound) "
              f"{rep.tok_s_ceiling:.1f}")
        print(f"[serve] wall {rep.wall_s:.3f} s, "
              f"{rep.tok_s:.2f} generated tok/s")
    return rep


def serve_continuous(
    arch: str = "qwen2-0.5b",
    smoke: bool = False,
    device: str = "trace",
    num_requests: int = 6,
    arrival_rate: float = 0.5,
    arrival_kind: str = "poisson",
    max_batch: int = 2,
    prompt_len: int = 512,
    n_tokens: int = 64,
    batch: int = 1,
    hbm_kv_budget: int = 1 << 22,
    page_tokens: int = 64,
    kv_capacity_bytes: Optional[int] = None,
    capacity_model: str = "logical",
    degrade_ladder=(),
    prefix_share: bool = False,
    share_prefix_len: int = 0,
    lossless_only: bool = False,
    async_io: bool = True,
    seed: int = 0,
    sanitize: Optional[bool] = None,
    shards: Optional[int] = None,
    placement: Optional[str] = None,
    slo_ttft_s: Optional[float] = None,
    slo_tpot_s: Optional[float] = None,
    pnm_topk: Optional[int] = None,
    importance: str = "recency",
    torch_device=None,
    params=None,
    verbose: bool = True,
):
    """Continuous batching: run a synthetic arrival trace of
    ``num_requests`` through a :class:`ServeScheduler` and report modeled
    throughput and latency percentiles.  Returns ``(scheduler, report)``;
    the other arguments are as for :func:`serve`."""
    dev = devices.resolve(torch_device)
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_config(cfg)
    if params is None:
        params = init_params(cfg, seed=seed, device=dev)
    policy = LOSSLESS_POLICY if lossless_only else PAPER_POLICY
    trace = synth.request_trace(
        num_requests, cfg.vocab, rate=arrival_rate, kind=arrival_kind,
        prompt_len=prompt_len, new_tokens=n_tokens, batch=batch, seed=seed,
        share_prefix_len=share_prefix_len,
    )
    sched = ServeScheduler(
        cfg, params, max_batch=max_batch, device_kind=device, policy=policy,
        batch=batch, page_tokens=page_tokens, hbm_kv_budget=hbm_kv_budget,
        kv_capacity_bytes=kv_capacity_bytes, capacity_model=capacity_model,
        degrade_ladder=degrade_ladder, prefix_share=prefix_share,
        async_io=async_io, sanitize=sanitize, shards=shards,
        placement=placement, slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
        pnm_topk=pnm_topk, importance=importance, device=dev,
    )
    rep = sched.run(trace)
    if not verbose:
        return sched, rep
    d = sched.device_stats()
    print(f"[serve] arch={cfg.name} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} tier={device} on {dev} continuous "
          f"batching: {num_requests} requests, {arrival_kind} rate "
          f"{arrival_rate}/round, max_batch {max_batch}, capacity model "
          f"{capacity_model}")
    print(f"[serve] {rep.steps} rounds, {rep.decode_tokens} decode tokens in "
          f"{rep.model_time_s * 1e3:.2f} modeled ms → {rep.tok_s:.1f} tok/s "
          f"(peak admitted batch {rep.peak_active})")
    print(f"[serve] latency p50 {rep.p50_latency_s * 1e3:.2f} ms, "
          f"p99 {rep.p99_latency_s * 1e3:.2f} ms, mean queue delay "
          f"{rep.mean_queue_delay_s * 1e3:.2f} ms")
    print(f"[serve] TTFT p50 {rep.p50_ttft_s * 1e3:.2f} ms, "
          f"p99 {rep.p99_ttft_s * 1e3:.2f} ms; "
          f"TPOT mean {rep.mean_tpot_s * 1e3:.2f} ms/tok")
    if slo_ttft_s is not None or slo_tpot_s is not None:
        targets = []
        if slo_ttft_s is not None:
            targets.append(f"TTFT <= {slo_ttft_s * 1e3:g} ms")
        if slo_tpot_s is not None:
            targets.append(f"TPOT <= {slo_tpot_s * 1e3:g} ms/tok")
        print(f"[serve] SLO attainment {rep.slo_attainment * 100:.1f}% "
              f"({' and '.join(targets)}, "
              f"{len(rep.records)} finished requests)")
    if capacity_model == "physical":
        print(f"[serve] admission ratio estimate "
              f"{rep.kv_ratio_estimate:.2f}x"
              + (f", reclaimed {rep.reclaimed_bytes} B via degrade ladder"
                 if rep.reclaimed_bytes else ""))
    if prefix_share:
        proj = sum(r.kv_projected_bytes for r in rep.records)
        novel = sum(r.kv_charged_bytes for r in rep.records)
        print(f"[serve] prefix share: admission charged {novel} of {proj} "
              f"projected KV bytes ({proj - novel} B already resident as "
              f"shared pages)")
    if rep.n_devices > 1:
        print(f"[serve] fleet: {rep.n_devices} devices "
              f"(placement {placement or 'hash-stripe'}), "
              f"skew {rep.fleet_skew:.2f}x max/mean moved bytes")
    print(f"[serve] tier after retirement: stored {d.dram_bytes_stored} B, "
          f"{d.blocks} blocks (retired requests freed their namespaces)")
    return sched, rep


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--device", default="trace",
                    choices=["plain", "gcomp", "trace"],
                    help="tier device kind")
    ap.add_argument("--cpu", action="store_true",
                    help="run the model and kernels' plain versions on the "
                         "CPU instead of the card")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced-width model (the CPU smoke config)")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--hbm-kv-budget", type=int, default=1 << 22,
                    help="HBM bytes for resident KV pages per request")
    ap.add_argument("--sync-io", action="store_true",
                    help="serialize spill readback (disable the async queue)")
    ap.add_argument("--lossless-only", action="store_true")
    ap.add_argument("--pnm-topk", type=int, default=None,
                    help="PNM read mode: a device-side top-K gather per KV "
                         "kind replaces full spill readback (K >= spilled "
                         "pages reads back exactly what the classic path "
                         "does); default off")
    ap.add_argument("--importance", default="recency",
                    choices=["recency", "attention"],
                    help="page-importance signal: commit recency, or "
                         "attention mass accumulated every boundary")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve against a fleet of N tier devices; 0 defers "
                         "to the TRACE_SHARDS env var, 1 pins one device")
    ap.add_argument("--placement", default=None,
                    choices=["hash-stripe", "namespace",
                             "replicate-weights"],
                    help="fleet placement policy (with --shards > 1): "
                         "hash-stripe spreads pages by key hash, "
                         "namespace pins whole request namespaces per "
                         "shard, replicate-weights copies TENSOR writes "
                         "to every shard and reads them from the "
                         "least-busy replica")
    ap.add_argument("--streams", type=int, default=1,
                    help="sequences per request sharing one tier queue, "
                         "decoding round-robin")
    ap.add_argument("--num-requests", type=int, default=0,
                    help="run the continuous-batching scheduler on a "
                         "synthetic trace of this many requests")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="offered load, requests per decode round")
    ap.add_argument("--arrival-kind", default="poisson",
                    choices=["poisson", "bursty"])
    ap.add_argument("--max-batch", type=int, default=2,
                    help="scheduler batch slots (active requests)")
    ap.add_argument("--kv-capacity", type=int, default=0,
                    help="KV admission capacity in bytes (0 = unlimited)")
    ap.add_argument("--capacity-model", default="logical",
                    choices=["logical", "physical"],
                    help="admit against logical BF16 bytes or the residency "
                         "ledger's physical (compressed) footprint")
    ap.add_argument("--degrade-ladder", default="none",
                    help="reclamation ladder: 'none', 'default' "
                         "(man4,man2,man0) or a comma list of view names; "
                         "a blocked admission sheds cold pages' mantissa "
                         "planes in place before stalling (needs "
                         "--capacity-model physical)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="store identical prompt-prefix KV pages once "
                         "(refcounted, copy-on-write at divergence) and "
                         "charge admission only the novel KV")
    ap.add_argument("--share-prefix-len", type=int, default=0,
                    help="leading prompt tokens every synthetic request "
                         "shares (a common system prompt)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT target in modeled ms (reports attainment)")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="TPOT target in modeled ms per output token")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the tier with the accounting sanitizer on "
                         "(same as TRACE_SANITIZE=1)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    ladder = parse_degrade_ladder(args.degrade_ladder)
    if ladder and args.capacity_model != "physical":
        raise SystemExit(
            "--degrade-ladder requires --capacity-model physical: "
            "reclamation frees stored bytes, which the logical "
            "projection never looks at")
    if args.share_prefix_len and not args.prefix_share:
        print("[serve] note: --share-prefix-len shapes the trace only; "
              "add --prefix-share to actually dedup the shared pages")
    torch_device = "cpu" if args.cpu else None
    if args.num_requests > 0:
        if args.streams > 1:
            print("[serve] note: --streams is ignored in continuous-"
                  "batching mode (concurrency comes from --max-batch)")
        serve_continuous(
            arch=args.arch, smoke=args.smoke, device=args.device,
            num_requests=args.num_requests, arrival_rate=args.arrival_rate,
            arrival_kind=args.arrival_kind, max_batch=args.max_batch,
            prompt_len=args.prompt_len, n_tokens=args.tokens,
            batch=args.batch, hbm_kv_budget=args.hbm_kv_budget,
            kv_capacity_bytes=args.kv_capacity or None,
            capacity_model=args.capacity_model, degrade_ladder=ladder,
            prefix_share=args.prefix_share,
            share_prefix_len=args.share_prefix_len,
            lossless_only=args.lossless_only, async_io=not args.sync_io,
            seed=args.seed, sanitize=args.sanitize or None,
            shards=args.shards or None, placement=args.placement,
            slo_ttft_s=(args.slo_ttft_ms / 1e3
                        if args.slo_ttft_ms is not None else None),
            slo_tpot_s=(args.slo_tpot_ms / 1e3
                        if args.slo_tpot_ms is not None else None),
            pnm_topk=args.pnm_topk, importance=args.importance,
            torch_device=torch_device)
        return
    if args.prefix_share:
        print("[serve] note: --prefix-share applies to continuous-"
              "batching mode (--num-requests N)")
    serve(arch=args.arch, smoke=args.smoke, device=args.device,
          prompt_len=args.prompt_len, n_tokens=args.tokens, batch=args.batch,
          requests=args.requests, hbm_kv_budget=args.hbm_kv_budget,
          lossless_only=args.lossless_only, streams=args.streams,
          async_io=not args.sync_io, pnm_topk=args.pnm_topk,
          importance=args.importance, shards=args.shards or None,
          placement=args.placement, sanitize=args.sanitize or None,
          seed=args.seed, torch_device=torch_device)


if __name__ == "__main__":
    main()
