"""Continuous-batching serving: requests arrive, join, leave, and free KV.

Walks the ``ServeScheduler`` lifecycle on the smoke model:

1. a Poisson arrival trace (requests per decode round) from
   ``synth.request_trace``;
2. FIFO admission into batch slots as capacity allows — the logical-KV
   capacity is throttled so admission visibly waits on retirements;
3. each retirement frees the request's HBM pages and deletes its tier
   key namespace, which lets the next queued request join, and the tier
   is empty after the last one;
4. every request's tokens equal running it alone through
   ``ServeEngine.generate``;
5. the same trace under ``capacity_model="physical"`` admits against the
   device's residency ledger (projection over the observed compression
   ratio) and overlaps at least as many requests.

The model is qwen2-0.5b at ``smoke_config`` with random weights, on the
card unless ``--cpu``.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_continuous [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import devices
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import synth
from repro_torch.models.model import init_params
from repro_torch.runtime import (
    ServeEngine, ServeScheduler, projected_kv_bytes,
)
from repro_torch.runtime.paging import LOSSLESS_POLICY


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the model and the tier's kernels on the CPU")
    args = ap.parse_args(argv)
    device = devices.resolve("cpu" if args.cpu else None)
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = init_params(cfg, seed=0, device=device)
    n_req, prompt_len, new_tok = 6, 32, 6

    def trace():
        return synth.request_trace(
            n_req, cfg.vocab, rate=0.6, kind="poisson",
            prompt_len=prompt_len, new_tokens=new_tok, seed=3,
        )

    # capacity for ~2.5 requests of projected KV: two run concurrently,
    # a third waits for a retirement even when a batch slot is free
    proj = projected_kv_bytes(cfg, 1, prompt_len + new_tok, 16)
    common = dict(max_batch=3, device_kind="trace", policy=LOSSLESS_POLICY,
                  page_tokens=16, hbm_kv_budget=1 << 12,
                  kv_capacity_bytes=int(2.5 * proj), device=device)
    sched = ServeScheduler(cfg, params, **common)
    print(f"== continuous batching: {n_req} requests, poisson 0.6/round, "
          f"max_batch 3, KV capacity {int(2.5 * proj)} B "
          f"(~2.5x per-request projection {proj} B) ==")
    reqs = trace()
    rep = sched.run(reqs)
    for r in rep.records:
        print(f"req {r.req_id}: arrived {r.arrival:5.2f}, admitted step "
              f"{r.admit_step:2d}, finished step {r.finish_step:2d}, "
              f"queue delay {r.queue_delay_s * 1e3:6.2f} ms, latency "
              f"{r.latency_s * 1e3:6.2f} ms")
    print(f"{rep.steps} rounds → {rep.tok_s:.1f} tok/s, p50 "
          f"{rep.p50_latency_s * 1e3:.2f} ms, p99 "
          f"{rep.p99_latency_s * 1e3:.2f} ms")

    d = sched.device_stats()
    print(f"tier after the last retirement: {d.dram_bytes_stored} B stored, "
          f"{d.blocks} blocks (every namespace freed)")
    assert d.dram_bytes_stored == 0 and d.blocks == 0

    # each request alone, same seed → identical tokens
    for req, rec in zip(reqs, rep.records):
        solo = ServeEngine(
            cfg, params, max_seq=sched.max_seq, batch=1, page_tokens=16,
            hbm_kv_budget=1 << 12, device_kind="trace",
            policy=LOSSLESS_POLICY, device=device,
        ).generate(req["prompt"], req["max_new_tokens"], seed=req["seed"])
        assert np.array_equal(solo, rec.tokens)
    print("per-request tokens bit-identical to solo runs ✓")

    # the same trace under the physical capacity model
    phys = ServeScheduler(cfg, params, capacity_model="physical", **common)
    rep_p = phys.run(trace())
    print("== same trace, capacity_model='physical' ==")
    print(f"peak admitted batch {rep.peak_active} → {rep_p.peak_active}, "
          f"tok/s {rep.tok_s:.1f} → {rep_p.tok_s:.1f} "
          f"(observed ratio {rep_p.kv_ratio_estimate:.2f}x); "
          f"TTFT p50 {rep_p.p50_ttft_s * 1e3:.2f} ms, "
          f"TPOT {rep_p.mean_tpot_s * 1e3:.2f} ms/tok")
    assert rep_p.peak_active >= rep.peak_active
    return dict(report=rep, physical=rep_p, stored=d.dram_bytes_stored,
                blocks=d.blocks)


if __name__ == "__main__":
    main()
