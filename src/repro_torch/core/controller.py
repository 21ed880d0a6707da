"""Controller pipeline timing (paper §III-D / §IV-E): the load-to-use
anchors ``LinkModel.for_design`` prices receipts with.

Calibrated so the published operating points are reproduced exactly:

  Table V   load-to-use: Plain 71, GComp 84, TRACE 89 cycles @ 2 GHz
  Fig. 23   TRACE latency vs compression ratio: 89 @ 1.5x → 85 @ 3.0x
"""

from __future__ import annotations

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


def load_to_use_cycles(design: str, comp_ratio: float = 1.5) -> float:
    """Device-local load-to-use service time in cycles (index-cache hit,
    codec not bypassed)."""
    s = STAGES[design]
    fixed = s["front"] + s["meta"] + s["sched"] + s["trcd"] + s["tcl"]
    if design == "plain":
        return fixed + s["burst"]
    a, c = _VAR[design]
    return fixed + a / max(comp_ratio, 1.0) + c


def load_to_use_ns(design: str, comp_ratio: float = 1.5) -> float:
    return load_to_use_cycles(design, comp_ratio) / CLOCK_GHZ
