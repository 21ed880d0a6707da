"""Trace-driven decoding-throughput model (paper §IV-B, Figs. 12-14).

First-order bandwidth accounting: per-step traffic is decomposed into
weight reads + KV reads/writes; each tier (HBM, CXL link, CXL device DDR)
converts bytes-per-step into a tok/s ceiling and decode rate is the
bottleneck, additionally capped by a GPU compute ceiling.  The model
isolates how *bytes-per-token* changes (compression, plane-aligned elastic
fetch) move the ceilings — it does not model queueing.

Calibration: the paper gives the structure but not every constant; the
free parameters below were reverse-engineered so the published anchors
are reproduced:

  * Fig. 12 all-designs plateau 68.99 tok/s → compute/HBM cap `cap_tok_s`.
  * CXL-GComp ≈ CXL-Plain once KV-bound → the inline KV-path codec is LZ4,
    whose ratio on token-major KV is ~1.0 (Table I: LZ4 KV = 0.0%).
  * Plain = 16.28/8.21/5.49 tok/s at 128/196/256k → kv concurrency
    ``batch≈4`` with ``f_rd≈0.8`` and hot-KV budget = HBM − weights.
  * TRACE returning to the 68.99 cap at 128k is NOT reachable with the
    lossless ratio (1.8×) alone; it additionally requires elastic
    precision on spilled KV pages (`elastic_spill_bits`≈6, i.e. the
    Table II mixed BF16/FP8/FP4 page policy) — consistent with the
    paper's title: compression AND precision scaling.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """LLM shape terms that generate traffic."""

    name: str
    weight_bytes: float          # total stored weight footprint
    active_weight_bytes: float   # weight bytes *read per step* (MoE: active)
    kv_bytes_per_token: float    # layers * 2 * kv_heads * head_dim * elem
    batch: int = 4               # concurrent sequences (KV scales, weights amortise)


# GPT-OSS-120B (model card arXiv:2508.10925): 36 layers, d_model 2880,
# 64 q / 8 kv heads, head_dim 64, 128 experts top-4, ~5.1B active params.
def gpt_oss_120b(fmt: str = "mxfp4", batch: int = 4) -> ModelSpec:
    n_total, n_active = 116.8e9, 5.1e9
    bpw = {"mxfp4": 0.514, "bf16": 2.0}[fmt]    # ~60 GB / ~240 GB stored
    kv = 36 * 2 * 8 * 64 * 2.0                  # KV kept in BF16
    return ModelSpec(
        f"gpt-oss-120b-{fmt}", n_total * bpw, n_active * bpw, kv, batch
    )


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Paper §IV-B: single GPU + one CXL Type-3 device (also the constants
    ``ServeEngine.throughput_ceiling`` converts tier traffic with)."""

    hbm_bytes: float = 76e9          # usable HBM
    hbm_bw: float = 4.2e12           # HBM3E-class
    cxl_link_bw: float = 512e9       # per direction
    cxl_ddr_bw: float = 256e9        # device-side DDR
    f_rd: float = 0.8                # fraction of spilled context read/step
    cap_tok_s: float = 68.99         # GPU compute ceiling (Fig. 12 plateau)


@dataclasses.dataclass(frozen=True)
class DesignRatios:
    """Average compressed-size ratios of the device inline codec (LZ4 —
    the latency-sensitive path, paper §III-B) on 4 KB blocks."""

    weight: float = 1.0              # S_orig / S_comp for stored weights
    kv: float = 1.0

    @classmethod
    def for_design(cls, design: str, weight_fmt: str = "bf16") -> "DesignRatios":
        # Paper-measured LZ4 corpus ratios; benchmarks can override with
        # ratios measured by this repo's own pipeline (core.tier).
        table = {
            "plain": dict(bf16=(1.00, 1.00), mxfp4=(1.00, 1.00)),
            "gcomp": dict(bf16=(1.10, 1.02), mxfp4=(1.01, 1.02)),
            "trace": dict(bf16=(1.25, 1.80), mxfp4=(1.02, 1.80)),
        }
        w, kv = table[design][weight_fmt]
        return cls(weight=w, kv=kv)


@dataclasses.dataclass
class Breakdown:
    tok_s: float
    bottleneck: str
    hbm_bytes: float
    link_bytes: float
    ddr_bytes: float
    kv_spill_frac: float
    w_spill_frac: float


def throughput(
    model: ModelSpec,
    ctx: int,
    design: str,
    sys: SystemSpec = SystemSpec(),
    alpha: float | None = None,
    ratios: DesignRatios | None = None,
    weight_fmt: str | None = None,
    elastic_spill_bits: float | None = 6.0,
) -> Breakdown:
    """Per-stream decode tok/s at context length ``ctx`` for one design.

    ``elastic_spill_bits``: average bits/element at which TRACE serves
    *spilled* KV pages via plane-aligned fetch (None disables elasticity →
    lossless-only TRACE).  Ignored for plain/gcomp (word devices cannot
    fetch sub-container precision — paper Issue 2).
    """
    fmt = weight_fmt or ("mxfp4" if "mxfp4" in model.name else "bf16")
    r = ratios or DesignRatios.for_design(design, fmt)

    # --- capacity split (Eq. 9) ---------------------------------------------
    if alpha is None:
        h_w = min(model.weight_bytes, sys.hbm_bytes)     # weight-priority
    else:
        h_w = alpha * sys.hbm_bytes
    w_resident = min(model.weight_bytes, h_w)
    w_spill_frac = 1.0 - w_resident / model.weight_bytes
    h_kv = max(sys.hbm_bytes - w_resident, 0.0)

    kv_total = model.kv_bytes_per_token * ctx * model.batch
    kv_resident_frac = min(1.0, h_kv / kv_total) if kv_total > 0 else 1.0
    kv_spill_frac = 1.0 - kv_resident_frac

    # --- per-step traffic ----------------------------------------------------
    w_read = model.active_weight_bytes                    # one sweep per step
    kv_read_hot = sys.f_rd * kv_total * kv_resident_frac
    kv_read_spill = sys.f_rd * kv_total * kv_spill_frac
    kv_write = model.kv_bytes_per_token * model.batch

    hbm_bytes = w_read * (1 - w_spill_frac) + kv_read_hot + kv_write

    # Elastic precision on spilled pages: bytes scale with fetched planes
    # on BOTH the device DDR and the link (plane-aligned fetch, §III-C).
    elastic = 1.0
    if design == "trace" and elastic_spill_bits is not None:
        elastic = 16.0 / elastic_spill_bits

    link_bytes = w_read * w_spill_frac + kv_read_spill / elastic
    ddr_bytes = (
        w_read * w_spill_frac / r.weight
        + kv_read_spill / (r.kv * elastic)
        + kv_write * kv_spill_frac / r.kv
    )

    # --- ceilings ------------------------------------------------------------
    times = {
        "hbm": hbm_bytes / sys.hbm_bw,
        "cxl-link": link_bytes / sys.cxl_link_bw,
        "cxl-ddr": ddr_bytes / sys.cxl_ddr_bw,
    }
    bottleneck = max(times, key=times.get)
    step_time = max(max(times.values()), 1e-12)
    tok_s = min(1.0 / step_time, sys.cap_tok_s)
    if tok_s == sys.cap_tok_s:
        bottleneck = "compute-cap"
    return Breakdown(
        tok_s, bottleneck, hbm_bytes, link_bytes, ddr_bytes,
        kv_spill_frac, w_spill_frac,
    )


def sweep_context(model, ctxs, designs=("plain", "gcomp", "trace"), **kw):
    return {
        d: [throughput(model, c, d, **kw).tok_s for c in ctxs] for d in designs
    }


def sweep_alpha(model, ctx, alphas, designs=("plain", "gcomp", "trace"), **kw):
    return {
        d: [throughput(model, ctx, d, alpha=a, **kw).tok_s for a in alphas]
        for d in designs
    }


# Published anchor points used by the calibration benchmark (Fig. 12-14).
PAPER_ANCHORS_FIG12 = {  # (ctx → tok/s), GPT-OSS-120B-MXFP4, weights fit
    "plain": {65536: 68.99, 131072: 16.28, 196608: 8.21, 262144: 5.49},
    "trace": {65536: 68.99, 131072: 68.99, 196608: 32.03, 262144: 16.28},
}
PAPER_ANCHORS_FIG13 = {  # GPT-OSS-120B BF16, alpha=0.8, 4k / 128k
    "plain": {4096: 33.61, 131072: 10.97},
    "gcomp": {4096: 36.97, 131072: 11.30},
    "trace": {4096: 42.02, 131072: 40.29},
}
