"""Serving with elastic KV precision: quality/traffic trade-off sweep.

Runs the same prompt through four KV page policies on a TRACE tier and
prints the quality (logit divergence vs lossless) / tier-traffic frontier
— the end-to-end demonstration of the paper's Table II + Mechanism II.
The model is stablelm-12b at ``smoke_config`` (layernorm, swiglu) with
random weights, on the card unless ``--cpu``.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_elastic [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import devices
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.precision import FULL, MAN0, MAN2, MAN4
from repro_torch.models.model import init_params
from repro_torch.runtime import ServeEngine
from repro_torch.runtime.paging import LOSSLESS_POLICY, PagePolicy

POLICIES = {
    "lossless (all BF16)": LOSSLESS_POLICY,
    "paper mix (5 BF16 / 3 ~FP8 / rest ~FP4)": PagePolicy(
        tiers=((5, FULL), (3, MAN4), (2, MAN0)), tail_view=MAN0
    ),
    "mid (all man2+guard)": PagePolicy(tiers=((1 << 30, MAN2),),
                                       tail_view=MAN2),
    "aggressive (all man0+guard)": PagePolicy(
        tiers=((1 << 30, MAN0),), tail_view=MAN0
    ),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the model and the tier's kernels on the CPU")
    args = ap.parse_args(argv)
    device = devices.resolve("cpu" if args.cpu else None)
    cfg = smoke_config(ARCHS["stablelm-12b"])
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (1, 96)).astype(np.int32)
    follow = rng.integers(0, cfg.vocab, (24, 1, 1)).astype(np.int32)

    results = {}
    last_eng = None
    for name, pol in POLICIES.items():
        eng = ServeEngine(
            cfg, params, max_seq=160, batch=1, page_tokens=16,
            hbm_kv_budget=1 << 11, device_kind="trace", policy=pol,
            device=device,
        )
        logits = [eng.prefill(prompt)]
        for t in follow:                      # teacher-forced comparison
            logits.append(eng.decode(t))
        results[name] = (np.stack(logits), eng.stats())
        last_eng = eng

    base = results["lossless (all BF16)"][0]
    print(f"{'policy':45s} {'logit MSE':>10s} {'top1 agree':>10s} "
          f"{'tier DRAM read':>14s}")
    rows = {}
    for name, (lg, st) in results.items():
        mse = float(np.mean((lg - base) ** 2))
        top1 = float(np.mean(lg.argmax(-1) == base.argmax(-1)))
        rows[name] = dict(mse=mse, top1=top1, dram_read=st.tier_dram_read)
        print(f"{name:45s} {mse:10.4f} {top1:10.2%} "
              f"{st.tier_dram_read:12d} B")

    # Receipts attribute tier traffic per layer — no global-counter diffing.
    print("\nper-layer tier DRAM traffic (aggressive policy, from receipts):")
    per_layer = sorted(last_eng.layer_traffic().items())
    for layer, t in per_layer:
        print(f"  layer {layer}: read {t.dram_bytes_read:9d} B  "
              f"written {t.dram_bytes_written:9d} B  "
              f"({t.requests} requests)")
    return dict(rows=rows, per_layer={layer: t.dram_bytes_read
                                      for layer, t in per_layer})


if __name__ == "__main__":
    main()
