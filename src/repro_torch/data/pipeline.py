"""Deterministic, sharded, checkpointable data: the reference's synthetic
token stream (``repro.data.pipeline``), byte for byte.

No datasets ship offline, so the source is a synthetic stream with
LLM-like statistics: a Zipfian unigram and a bank of repeated n-gram
phrases, so the loss falls as a model learns them.  The contract is a
corpus loader's:

* **sharded**: each data-parallel rank reads a disjoint slice, derived
  from ``(step, rank)`` alone;
* **deterministic and checkpointable**: a batch is a pure function of
  ``(seed, step)``, so the iterator's state is the integer step the
  train checkpoint stores, and a restart (on any rank count) resumes the
  exact sample sequence.

``DataConfig`` and ``ShardedTokenStream`` are numpy only, the
reference's code, so every ``(step, rank, world)`` gives its bytes;
``make_train_iterator`` places batches on a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .. import devices


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic-structure knobs
    zipf_a: float = 1.2
    ngram: int = 8            # repeated-phrase length (gives learnable signal)
    repeat_p: float = 0.5     # probability a position continues a phrase


class ShardedTokenStream:
    """Stateless-per-step token source: ``batch_at(step, rank, world)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # A fixed bank of "phrases" — repeated n-grams the model can learn.
        ranks = base.zipf(cfg.zipf_a, size=(1024, cfg.ngram)).astype(np.int64)
        self._phrases = (ranks - 1) % cfg.vocab

    def _sequence(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, dtype=np.int32)
        i = 0
        while i < out.size:
            if rng.random() < cfg.repeat_p:
                ph = self._phrases[rng.integers(len(self._phrases))]
                take = min(len(ph), out.size - i)
                out[i : i + take] = ph[:take]
                i += take
            else:
                out[i] = (rng.zipf(cfg.zipf_a) - 1) % cfg.vocab
                i += 1
        return out

    def batch_at(self, step: int, rank: int = 0, world: int = 1) -> dict:
        """Per-rank slice of the global batch for ``step``: ``seq_len + 1``
        tokens a row as ``tokens`` (the first ``seq_len``) and ``labels``
        (the last ``seq_len``), both int32 (per_rank, seq_len)."""
        cfg = self.cfg
        per_rank = cfg.global_batch // world
        if per_rank * world != cfg.global_batch:
            raise ValueError(f"global_batch {cfg.global_batch} not "
                             f"divisible by world {world}")
        rows = []
        for b in range(per_rank):
            # deterministic stream id: (step, global row index)
            g = rank * per_rank + b
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, g])
            )
            rows.append(self._sequence(rng))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def batch_rows(sharding) -> tuple:
    """``(rank, world)`` of this rank's rows of the global batch under
    ``sharding`` (a :class:`..models.sharding.NamedSharding` of the (B, S)
    arrays): its index along the mesh dims of dim 0, outer dim first;
    ``(0, 1)`` for None."""
    if sharding is None:
        return 0, 1
    from ..models.sharding import coordinate, mesh_dims

    return coordinate(sharding.mesh, mesh_dims(sharding.spec[0]))


def make_train_iterator(cfg: DataConfig,
                        device: Union[str, torch.device, None] = None,
                        start_step: int = 0, batch_sharding=None):
    """Yield ``(step, batch)`` forever from ``start_step``: the stream's
    arrays as int32 tensors on ``device`` (default: the card).
    ``batch_sharding``: a ``NamedSharding`` of the (B, S) arrays; each
    rank then draws only its rows (the stream's bytes, row for row) and
    gets them as a DTensor of that sharding."""
    dev = devices.resolve(device)
    stream = ShardedTokenStream(cfg)
    rank, world = batch_rows(batch_sharding)
    step = start_step
    while True:
        host = stream.batch_at(step, rank, world)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in host.items()}
        if batch_sharding is not None:
            batch = {k: _rows_dtensor(v, batch_sharding, cfg.global_batch)
                     for k, v in batch.items()}
        yield step, batch
        step += 1


def _rows_dtensor(rows: torch.Tensor, sharding, global_batch: int):
    from torch.distributed.tensor import DTensor

    shape = (global_batch,) + tuple(rows.shape[1:])
    return DTensor.from_local(rows, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
