"""Quickstart: TRACE's two mechanisms on a real tensor.

Writes one synthetic KV block through the three device designs (ratio
per design), reads it back losslessly through the legacy ``read_kv``,
then reads it at FULL and at the ``man4`` view in one batch (DRAM bytes
per view, the view's median relative error).  The tier's pack, LZ4 and
unpack kernels run on the card unless ``--cpu``.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import synth
from repro_torch.core.precision import VIEWS
from repro_torch.core.tier import KV, ReadReq, WriteReq, make_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the tier's kernels on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    # a KV block with LLM-like structure (smooth channels, mixed scales)
    kv = synth.kv_cache(n_tokens=512, n_channels=256, seed=0)

    # Mechanism I: the layout decides what the codec sees
    devs = {kind: make_device(kind, device=device)
            for kind in ("plain", "gcomp", "trace")}
    for dev in devs.values():
        rec, = dev.submit([WriteReq("kv", kv, kind=KV)])
        print(f"{dev.name:>6}: stored {rec.dram_bytes_stored:7d} B "
              f"for {rec.raw_bytes_stored} B logical "
              f"(ratio {dev.stats.compression_ratio:.2f}x)")
    trace = devs["trace"]

    # byte-exact round trip (the paper's correctness invariant)
    out = trace.read_kv("kv")
    np.testing.assert_array_equal(out, kv)
    print("lossless round-trip: OK")

    # Mechanism II: precision-proportional fetch, one batched submit
    full_rec, low_rec = trace.submit([
        ReadReq("kv", kind=KV),                      # all 16 planes
        ReadReq("kv", kind=KV, view=VIEWS["man4"]),  # sign+exp+4 mantissa
    ])
    full_bytes, low_bytes = full_rec.dram_bytes_read, low_rec.dram_bytes_read
    print(f"full-precision read: {full_bytes} B DRAM; "
          f"man4 view: {low_bytes} B ({low_bytes / full_bytes:.0%})")
    full = synth.bf16_bits_to_f32(full_rec.data)
    low = synth.bf16_bits_to_f32(low_rec.data)
    rel = np.median(np.abs(low - full) / (np.abs(full) + 1e-9))
    print(f"man4 median relative error: {rel:.2e} "
          f"(guard-plane round-to-nearest)")
    return dict(ratios={k: d.stats.compression_ratio
                        for k, d in devs.items()},
                full_bytes=full_bytes, low_bytes=low_bytes, rel=float(rel))


if __name__ == "__main__":
    main()
