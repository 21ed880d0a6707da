"""Controller pipeline timing + PPA model (paper §III-D / §IV-E).

Cycle-level stage model of the four-stage controller pipeline (Fig. 11),
calibrated so the published operating points are reproduced exactly:

  Table V   load-to-use: Plain 71, GComp 84, TRACE 89 cycles @ 2 GHz
  Fig. 22   stage split: F/M/S + tRCD/tCL/Burst, codec overlapped
  Fig. 23   TRACE latency vs compression ratio: 89 @ 1.5x → 85 @ 3.0x,
            bypass (incompressible) 76 cycles

The codec datapath streams and overlaps with the DRAM access window, so
only its non-overlapped tail is exposed (``v(r) = VAR_A / r + VAR_C``,
fitted to the two published points).  ``LinkModel.for_design`` prices
receipts with these anchors.

Area and power are the paper's ASAP7 synthesis numbers (Table V), data,
not a synthesis run.
"""

from __future__ import annotations

import dataclasses

CLOCK_GHZ = 2.0

STAGES = {
    # design:        F   M   S   tRCD tCL
    "plain": dict(front=3, meta=2, sched=8, trcd=18, tcl=22, burst=18),
    "gcomp": dict(front=3, meta=4, sched=9, trcd=18, tcl=22),
    "trace": dict(front=5, meta=2, sched=10, trcd=18, tcl=22),
}

# variable (burst + exposed-codec tail) term v(r) = A / r + C, fitted to
# Fig. 23 (TRACE) and GComp's single published point.
_VAR = {"trace": (12.0, 24.0), "gcomp": (12.0, 20.0)}

BYPASS_BURST = 19          # raw planes, codec skipped (Fig. 23: total 76)
INDEX_MISS_BURST = 2       # one 64 B index entry


def load_to_use_cycles(
    design: str,
    comp_ratio: float = 1.5,
    meta_hit: bool = True,
    bypass: bool = False,
) -> float:
    """Device-local load-to-use service time in cycles."""
    s = STAGES[design]
    fixed = s["front"] + s["meta"] + s["sched"] + s["trcd"] + s["tcl"]
    if design == "plain":
        total = fixed + s["burst"]
    elif bypass:
        total = fixed + BYPASS_BURST
    else:
        a, c = _VAR[design]
        total = fixed + a / max(comp_ratio, 1.0) + c
    if not meta_hit:
        # one extra DRAM access window fetches the index entry (§IV-E);
        # the data planes are not re-read
        total += s["trcd"] + s["tcl"] + INDEX_MISS_BURST
    return total


def load_to_use_ns(design: str, **kw) -> float:
    return load_to_use_cycles(design, **kw) / CLOCK_GHZ


# -- PPA (paper Table V; ASAP7 7 nm @ 2 GHz, 0.7 V) --------------------------
@dataclasses.dataclass(frozen=True)
class PPA:
    area_mm2: float
    power_w: float
    breakdown: dict


PPA_TABLE = {
    "plain": PPA(3.91, 9.0, dict(phy=3.50, metadata=0.21, scheduler=0.02,
                                 other=0.18)),
    "gcomp": PPA(
        6.66,
        21.4,
        dict(phy=3.50, codec=1.92, codec_sram=0.62, metadata=0.42,
             scheduler=0.02, other=0.18),
    ),
    "trace": PPA(
        7.14,
        22.4,
        dict(
            phy=3.50, codec=1.92, codec_sram=0.62, metadata=0.83,
            scheduler=0.03, transpose_recon=0.06, other=0.18,
        ),
    ),
}


def staging_sram_bytes(n_tokens: int, channels: int, elem_bytes: int = 2,
                       overhead: int = 64, n_streams: int = 1) -> int:
    """KV staging-buffer sizing, Eq. 4: S_buf = n·C·b + S_ovhd."""
    return n_streams * (n_tokens * channels * elem_bytes + overhead)
