"""Which KV pages a served request spills to the tier, when they come back
into the cache, and at which precision: the paged-KV rule of the TRACE
paper (§II-C, Table II) worked out from sizes alone.

The rule, as the traffic's parameters state it:

* the cache is cut into pages: a window of ``page_tokens`` positions of
  one layer and one kind (``k``, ``v`` or MLA's ``c_kv``) over every
  sequence of the batch.  A page is committed at the step that completes
  its window: the prompt's full windows at the prefill, then one at every
  ``page_tokens``-th decode step; a step commits its windows in position
  order, and each window's kinds, then layers, in order;
* committed pages stay in HBM while the budget holds them.  After a step's
  commit the oldest pages (by first position; ties in commit order) leave
  until the rest fit, and the pages that left are read back at that step;
* a page's view is fixed when it is read back, by its rank among every
  page spilled so far, newest first (ties in commit order), through the
  policy's ``(count, view)`` tiers and its tail view;
* a read issued at step ``s`` is waited for at the start of step
  ``s + 1``'s commit, after that step's forward: the forward of step
  ``s + 2`` is the first to see the view in the cache.

Step 0 is the prefill; step ``s`` > 0 the decode step that feeds position
``prompt_len + s - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Spill:
    issued: int          # step whose commit read the page back
    view: str            # the view it was read back at

    @property
    def visible(self) -> int:
        """First step whose forward reads the view from the cache."""
        return self.issued + 2


PageKey = Tuple[int, str, int]      # (paged layer, kind, first position)


def schedule(*, layers: int, kinds: Sequence[str], page_bytes: Dict[str, int],
             page_tokens: int, budget: int, prompt_len: int, steps: int,
             tiers: Sequence[Tuple[int, str]], tail: str
             ) -> Dict[PageKey, Spill]:
    """Every page that spills in a request of ``steps`` decode steps after
    a ``prompt_len``-token prefill, with when and how it comes back."""
    pages: List[list] = []           # [key, first position, resident]
    used = 0
    n_spilled = 0
    out: Dict[PageKey, Spill] = {}

    def view_for(rank: int) -> str:
        acc = 0
        for count, view in tiers:
            acc += count
            if rank < acc:
                return view
        return tail

    for step in range(steps + 1):
        lo, hi = (0, prompt_len) if step == 0 else (prompt_len + step - 1,
                                                    prompt_len + step)
        new = []
        start = lo - lo % page_tokens
        while start + page_tokens <= hi:
            for kind in kinds:
                for layer in range(layers):
                    new.append([(layer, kind, start), start, True])
            start += page_tokens
        if not new:
            continue
        pages.extend(new)
        used += sum(page_bytes[p[0][1]] for p in new)
        if used <= budget:
            continue
        events = []
        for p in sorted((p for p in pages if p[2]), key=lambda p: p[1]):
            if used <= budget:
                break
            p[2] = False
            used -= page_bytes[p[0][1]]
            events.append(p[0])
        n_spilled += len(events)
        spilled = sorted((p for p in pages if not p[2]), key=lambda p: -p[1])
        rank = {p[0]: i for i, p in enumerate(spilled)}
        for key in events:
            out[key] = Spill(step, view_for(rank[key]))
    return out
