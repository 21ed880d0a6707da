"""Weight offload through the TRACE tier with elastic per-unit precision.

The paper's second traffic stream (§IV-D): weights are re-read every
decode step; when they spill past HBM the tier serves them, and a TRACE
device can serve each *unit* (expert / attention head / MLP neuron) at
its runtime-assigned precision view through plane-aligned fetch
(Granularity I/II), while word devices always move full containers.

:class:`WeightStore` writes each unit once (bit-plane compressed on
TRACE: the pack and LZ4 match kernels on the card) and reads it
back at its view (the standalone unpack + view round on the card),
tallying device-DRAM and link bytes in the receipts, so a serving loop
can measure the traffic of an importance policy with real bytes (the
Fig. 18-21 experiment).  It never calls the elastic matmul, which reads
planes in place (``kernels.ops``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

from ..core.precision import FULL, MAN0, MAN2, MAN4, PrecisionView
from ..core.synth import to_bf16_bits
from ..core.tier import ReadReq, TierStore, WriteReq, make_device

# Precision tiers by unit importance rank fraction (Fig. 17-style mix).
DEFAULT_TIERS = ((0.4, FULL), (0.3, MAN4), (0.2, MAN2), (0.1, MAN0))


@dataclasses.dataclass
class UnitMeta:
    name: str
    shape: tuple
    importance: float


def _bf16_words(w) -> np.ndarray:
    """A unit's BF16 bit patterns as host uint16: a tensor is cast to
    bf16 (round to nearest even) and copied to the host; a numpy array
    is cast through float32, as ``ml_dtypes`` casts it."""
    if isinstance(w, torch.Tensor):
        t = w.detach()
        if t.dtype != torch.bfloat16:
            t = t.to(torch.bfloat16)
        return t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return to_bf16_bits(np.asarray(w))


class WeightStore:
    """Unit-granular weight storage on a tier device.

    ``tier`` is a :class:`TierStore` (or a fleet) or a device kind built
    on ``device`` (default: the card).  Units are tensors the runtime
    fetches independently; importance drives each one's view.
    """

    def __init__(self, tier: Union[TierStore, str] = "trace",
                 tiers=DEFAULT_TIERS,
                 device: Union[str, torch.device, None] = None):
        self.tier = (make_device(tier, device=device)
                     if isinstance(tier, str) else tier)
        self.tiers = tiers
        self._units: Dict[str, UnitMeta] = {}

    # -- write once -----------------------------------------------------------
    def put(self, name: str, w, importance: float = 1.0):
        self.put_many({name: (w, importance)})

    def put_many(self, units: Dict[str, tuple]):
        """Load ``name -> (weights, importance)`` units in one submit, so
        the device encodes the whole load as a few slab passes.  Units
        register only after the store accepted the batch."""
        reqs, metas = [], []
        for name, (w, importance) in units.items():
            reqs.append(WriteReq(name, _bf16_words(w), tag=name))
            metas.append(UnitMeta(name, tuple(np.shape(w)), importance))
        if reqs:
            self.tier.submit(reqs)
            for meta in metas:
                self._units[meta.name] = meta

    def set_importance(self, scores: Dict[str, float]):
        for k, v in scores.items():
            if k in self._units:
                self._units[k].importance = v

    # -- view assignment ------------------------------------------------------
    def view_for(self, name: str) -> PrecisionView:
        """The view of ``name``'s importance rank fraction under
        ``tiers`` (a stable sort: tied units keep insertion order)."""
        ranked = sorted(self._units.values(), key=lambda u: -u.importance)
        idx = next(i for i, u in enumerate(ranked) if u.name == name)
        frac = (idx + 0.5) / max(len(ranked), 1)
        acc = 0.0
        for width, view in self.tiers:
            acc += width
            if frac <= acc:
                return view
        return self.tiers[-1][1]

    # -- read per step --------------------------------------------------------
    def _tensor(self, name: str, words: np.ndarray) -> torch.Tensor:
        """The decoded words of ``name`` viewed as bf16 of its shape, on
        the tier's device."""
        t = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
        return t.reshape(self._units[name].shape).to(self.tier.device)

    def fetch(self, name: str,
              view: PrecisionView | None = None) -> torch.Tensor:
        view = view or self.view_for(name)
        rec, = self.tier.submit([ReadReq(name, view=view, tag=name)])
        return self._tensor(name, rec.data)

    def fetch_all(self) -> Dict[str, torch.Tensor]:
        """Every unit at its policy view in one batched submit: the
        per-decode-step weight stream as a single request batch."""
        reqs = [ReadReq(n, view=self.view_for(n), tag=n) for n in self._units]
        recs = self.tier.submit(reqs)
        return {n: self._tensor(n, r.data) for n, r in zip(self._units, recs)}

    # -- accounting -----------------------------------------------------------
    @property
    def stats(self):
        return self.tier.stats

    def avg_bits(self) -> float:
        views = [self.view_for(n) for n in self._units]
        return float(np.mean([v.bits for v in views])) if views else 16.0
