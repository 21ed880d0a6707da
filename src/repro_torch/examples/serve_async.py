"""Multi-stream serving over one shared tier device queue.

Three demonstrations of the queued async front-end, smallest first:

1. raw tickets  — ``submit_async`` / ``wait`` / ``drain`` on a tier,
   showing the in-flight window (``pending``), coalesced execution and
   queue-delay receipts;
2. overlap      — one ``ServeEngine`` with ``async_io`` on and off:
   identical tokens and traffic, the async receipts pricing the
   decode/fetch overlap;
3. many streams — a ``MultiStreamEngine`` whose page pools share one
   device queue, per-stream traffic (the pools' ``page_traffic``)
   summing exactly to the shared device's totals.

The model is qwen2-0.5b at ``smoke_config`` with random weights, on the
card unless ``--cpu``.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_async [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import devices
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import synth
from repro_torch.core.tier import KV, ReadReq, WriteReq, make_device
from repro_torch.models.model import init_params
from repro_torch.runtime import MultiStreamEngine, ServeEngine
from repro_torch.runtime.paging import LOSSLESS_POLICY


def raw_tickets(device) -> dict:
    print("== raw tickets on a TierStore (window = 4) ==")
    dev = make_device("trace", kv_window=16, window=4, device=device)
    dev.submit([
        WriteReq(f"p{i}", synth.kv_cache(16, 64, seed=i), kind=KV)
        for i in range(8)
    ])
    tickets = [dev.submit_async([ReadReq(f"p{i}", kind=KV)])[0]
               for i in range(8)]
    done, pending = sum(t.done for t in tickets), dev.pending
    print(f"submitted 8 reads: {done} executed by window overflow, "
          f"{pending} still queued")
    dev.drain(tickets)
    # one coalesced group: widen the window so all 8 reads flush as a
    # single in-flight batch, then compare against serialized service
    dev.window = 64
    recs = dev.drain(dev.submit_async([ReadReq(f"p{i}", kind=KV)
                                       for i in range(8)]))
    total = max(r.latency_s for r in recs)     # one group: last delivery
    serial = sum(r.service_s for r in recs)
    print(f"one 8-read in-flight group: completion {total * 1e6:.2f} us vs "
          f"serialized {serial * 1e6:.2f} us ({serial / total:.1f}x overlap "
          "win)\n")
    return dict(done=done, pending=pending, total=total, serial=serial)


def overlap_single_stream(cfg, params, device) -> dict:
    print("== one stream, async_io on vs off (lossless policy) ==")
    prompt = (np.arange(48, dtype=np.int32) % cfg.vocab).reshape(1, 48)
    rows = {}
    for async_io in (False, True):
        eng = ServeEngine(
            cfg, params, max_seq=96, batch=1, page_tokens=16,
            hbm_kv_budget=1 << 12, device_kind="trace",
            policy=LOSSLESS_POLICY, async_io=async_io, device=device,
        )
        toks = eng.generate(prompt, 12)
        rows[async_io] = (toks, eng.stats())
    t_sync, s_sync = rows[False]
    t_async, s_async = rows[True]
    assert np.array_equal(t_sync, t_async), "async must not change tokens"
    print(f"tokens identical; tier DRAM read {s_async.tier_dram_read} B "
          f"(sync {s_sync.tier_dram_read} B)")
    print(f"async I/O: serialized {s_async.tier_io_service_s * 1e6:.1f} us, "
          f"queue delay {s_async.tier_io_queue_delay_s * 1e6:.1f} us\n")
    return dict(sync=s_sync, async_=s_async)


def many_streams(cfg, params, device, n=3) -> dict:
    print(f"== {n} streams sharing one device queue ==")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, 48)).astype(np.int32)
               for _ in range(n)]
    eng = MultiStreamEngine(
        cfg, params, n, device_kind="trace", max_seq=96, batch=1,
        page_tokens=16, hbm_kv_budget=1 << 12, policy=LOSSLESS_POLICY,
        device=device,
    )
    toks = eng.generate(prompts, 8)
    d = eng.device_stats()
    print(f"generated {[t.shape for t in toks]} tokens")
    per_read = [
        sum(t.dram_bytes_read for t in s.pool.page_traffic.values())
        for s in eng.streams
    ]
    print(f"per-stream DRAM reads {per_read} B  (sum {sum(per_read)} B "
          f"== device {d.dram_bytes_read} B)")
    assert sum(per_read) == d.dram_bytes_read
    print(f"aggregate tok/s ceiling: {eng.throughput_ceiling():.1f}")
    return dict(per_read=per_read, device_read=d.dram_bytes_read)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the model and the tier's kernels on the CPU")
    args = ap.parse_args(argv)
    device = devices.resolve("cpu" if args.cpu else None)
    out = {"raw": raw_tickets(device)}
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = init_params(cfg, seed=0, device=device)
    out["overlap"] = overlap_single_stream(cfg, params, device)
    out["streams"] = many_streams(cfg, params, device)
    return out


if __name__ == "__main__":
    main()
