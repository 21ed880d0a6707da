"""Serving entry point: generation with TRACE-tiered KV offload, on the card.

Serves ``--requests`` requests one after another through a
:class:`ServeEngine` at full model width (``--smoke`` reduces it), each
request on its own key namespace of one shared tier device and retired
when done.  Reports tier traffic, the KV compression ratio, the implied
tok/s ceiling and the wall-clock rate.

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
from ..core.tier import make_device
from ..models.model import init_params
from ..runtime import LOSSLESS_POLICY, PAPER_POLICY, ServeEngine


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
    async_io: bool = True,
    pnm_topk: Optional[int] = None,
    importance: str = "recency",
    shards: Optional[int] = None,
    placement: Optional[str] = None,
    seed: int = 0,
    torch_device=None,
    params=None,
    verbose: bool = True,
) -> ServeReport:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens, ``n_tokens``
    new tokens each.  ``device`` names the tier kind (``shards`` > 1: a
    fleet of them under ``placement``); ``torch_device`` is where the
    model and kernels run (default: the card).  ``params`` overrides the
    seeded random init."""
    dev = devices.resolve(torch_device)
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_config(cfg)
    if params is None:
        params = init_params(cfg, seed=seed, device=dev)
    policy = LOSSLESS_POLICY if lossless_only else PAPER_POLICY
    tier = make_device(device, shards=shards, placement=placement,
                       device=dev)
    rng = np.random.default_rng(seed)
    toks, wall = [], 0.0
    spilled = readback = gathered = logical = stored = 0
    ceiling = 0.0
    for r in range(requests):
        eng = ServeEngine(
            cfg, params, max_seq=prompt_len + n_tokens + page_tokens,
            batch=batch, page_tokens=page_tokens, hbm_kv_budget=hbm_kv_budget,
            device_kind=tier, policy=policy, key_prefix=f"r{r}.",
            async_io=async_io, pnm_topk=pnm_topk, importance=importance,
            device=dev,
        )
        prompt = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        toks.append(eng.generate(prompt, n_tokens))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall += time.perf_counter() - t0
        s = eng.stats()
        spilled += s.spilled_pages
        readback += eng.pool.pages_read
        gathered += eng.pool.pages_gathered
        logical += s.kv_logical_bytes
        stored += s.tier_dram_stored + s.hbm_page_bytes
        ceiling = eng.throughput_ceiling()
        eng.retire()
    d = tier.stats
    rep = ServeReport(
        tokens=toks, generated_tokens=requests * batch * n_tokens, wall_s=wall,
        spilled_pages=spilled, readback_pages=readback,
        gathered_pages=gathered,
        kv_logical_bytes=logical, kv_stored_bytes=stored,
        tier_dram_read=d.dram_bytes_read, tier_link_out=d.link_bytes_out,
        tok_s_ceiling=ceiling,
    )
    if verbose:
        print(f"[serve] arch={cfg.name} layers={cfg.n_layers} "
              f"d_model={cfg.d_model} tier={device} on {dev} "
              f"async_io={async_io}: {requests} requests x {batch} x "
              f"({prompt_len} prompt + {n_tokens} new) tokens")
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
                    choices=["hash-stripe", "namespace"],
                    help="fleet placement policy (with --shards > 1)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    serve(arch=args.arch, smoke=args.smoke, device=args.device,
          prompt_len=args.prompt_len, n_tokens=args.tokens, batch=args.batch,
          requests=args.requests, hbm_kv_budget=args.hbm_kv_budget,
          lossless_only=args.lossless_only, async_io=not args.sync_io,
          pnm_topk=args.pnm_topk, importance=args.importance,
          shards=args.shards or None, placement=args.placement,
          seed=args.seed, torch_device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
