"""The one traffic generator: a traffic file's parameters and a seed in,
the requests of a run out.

A traffic file (``portbench/traffic/<name>.json``) states:

* ``arrival``: ``"closed"`` (one client, which sends the next request once
  the previous one has retired; the only kind so far);
* ``batch``: sequences a request serves together;
* ``prompt_len``: ``{"min", "max", "multiple"}``: every prompt length is a
  multiple in ``[min, max]``.  Requests come in pairs whose lengths add
  up to ``min + max``: the first pair the shortest and the longest
  prompt, each later pair halfway between two sent before (``spread``),
  so that any number of pairs spans the range.  Every seed gets the same
  lengths in the same order, and so the same work and the same peak of
  memory; the seed draws the tokens (and the weights);
* ``new_tokens``: tokens generated a sequence;
* ``requests``: length of the schedule (a whole number of pairs),
  which the client cycles;
* the server's settings for the cell: ``page_tokens``, ``hbm_kv_budget``
  (bytes), ``tier`` (the tier device kind) and ``policy`` (``tiers``:
  ``[count, view]`` pairs in rank order, and the ``tail`` view);
* ``check``: ``sampled_requests``, how many finished requests the
  correctness check replays (the longest among them).

Token ids are uniform over the vocabulary.  Request ``i``'s tokens depend
on the seed and ``i`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

WARMUP = (1 << 32) - 1


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt_len: int
    new_tokens: int

    def prompt(self, seed: int, batch: int, vocab: int) -> np.ndarray:
        """(batch, prompt_len) int32 token ids."""
        rng = np.random.default_rng([int(seed), self.index & WARMUP])
        return rng.integers(0, vocab, (batch, self.prompt_len),
                            dtype=np.int64).astype(np.int32)


def lengths(spec: dict) -> List[int]:
    p = spec["prompt_len"]
    lo, hi, m = p["min"], p["max"], p["multiple"]
    if lo % m or hi % m or lo > hi or lo <= 0:
        raise ValueError(f"prompt_len {p}: min and max must be positive "
                         f"multiples of {m}, min <= max")
    return list(range(lo, hi + 1, m))


def spread(n: int) -> List[int]:
    """``0 .. n - 1`` in the order that halves the widest gap left: 0,
    n - 1, then each interval's midpoint, breadth first."""
    if n <= 0:
        return []
    out, seen, todo = [0], {0}, [(0, n - 1)]
    if n > 1:
        out.append(n - 1)
        seen.add(n - 1)
    while todo:
        nxt = []
        for a, b in todo:
            m = (a + b) // 2
            if m not in seen:
                out.append(m)
                seen.add(m)
            if m - a > 1:
                nxt.append((a, m))
            if b - m > 1:
                nxt.append((m, b))
        todo = nxt
    return out


def schedule(spec: dict) -> List[List[Request]]:
    """The run's requests in pairs, in the order the client sends them; a
    window holds whole pairs.  The same for every seed."""
    if spec.get("arrival") != "closed":
        raise ValueError(f"arrival {spec.get('arrival')!r}: only 'closed' "
                         "is generated")
    ls = lengths(spec)
    shorter = ls[:(len(ls) + 1) // 2]
    order = [shorter[k] for k in spread(len(shorter))]
    out: List[List[Request]] = []
    n = 0
    while 2 * len(out) < spec["requests"]:
        a = order[len(out) % len(order)]
        out.append([Request(n, a, spec["new_tokens"]),
                    Request(n + 1, ls[0] + ls[-1] - a, spec["new_tokens"])])
        n += 2
    return out


def warmup(spec: dict) -> Request:
    """The set-up's request: the largest prompt, and enough new tokens to
    commit a decode window and read spilled pages back."""
    return Request(WARMUP, lengths(spec)[-1],
                   min(spec["new_tokens"], spec["page_tokens"] + 2))
