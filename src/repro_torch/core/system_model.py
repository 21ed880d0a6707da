"""First-order system constants (paper §IV-B) that
``ServeEngine.throughput_ceiling`` converts tier traffic with."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Paper §IV-B: single GPU + one CXL Type-3 device."""

    cxl_link_bw: float = 512e9       # per direction
    cxl_ddr_bw: float = 256e9        # device-side DDR
    cap_tok_s: float = 68.99         # GPU compute ceiling (Fig. 12 plateau)
