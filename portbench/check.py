"""Whether what the timed path produced is correct.

After the window, a sample of the requests it finished, drawn from the
seed with the longest prompt in it, is replayed by the plain float32
reference (``reference/<model_type>.py``) from the same weights, prompts
and served tokens, with the spill schedule the reference works out for
itself (``reference/policy.py``).  Four numbers are compared, each with a
limit of the cell's own (``limits/<workload>.json``):

* ``prefill_gap``: over every sequence, how far the reference's logit of
  the first served token (the prefill's argmax) lies below the
  reference's best;
* ``decode_gap``: the same over every token the decode steps served,
  through the cache as the tier wrote it back;
* ``tier_pages_off``: pages whose readback the program issued at another
  step or view than the policy's, or did not issue, or issued unbidden;
* ``tier_words_off``: the words, a whole page each, of every page the
  policy spills whose cache slots do not hold the view of the words
  committed once the readback has written them (a digest of the slots,
  read from the cache on the card: ``probe.cache_digests``), or that
  were written back at another step than the one after their issue, or
  never; and of every page written back that the policy does not spill.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from .probe import digest
from .reference import policy, views

_KEY = re.compile(r"L(\d+)\.(\w+)\.(\d+)$")


def sample(requests, seed: int, n: int):
    """``n`` finished requests: the longest prompt (the first such), and
    the rest drawn from the seed."""
    done = [r for r in requests if r.finished]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len, -r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) \
        if rest and n > 1 else []
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def spill_schedule(cell, req):
    """The policy's schedule for ``req`` in ``cell``."""
    conf, t = cell.conf, cell.traffic
    ref = cell.reference()
    kinds = ref.PAGED_KINDS
    widths = paged_widths(conf)
    layers = conf["num_hidden_layers"] - conf.get("first_k_dense_replace", 0)
    page_bytes = {k: t["page_tokens"] * t["batch"] * widths[k] * 2
                  for k in kinds}
    return policy.schedule(
        layers=layers, kinds=kinds, page_bytes=page_bytes,
        page_tokens=t["page_tokens"], budget=t["hbm_kv_budget"],
        prompt_len=req.prompt_len, steps=req.new_tokens,
        tiers=[tuple(x) for x in t["policy"]["tiers"]],
        tail=t["policy"]["tail"])


def paged_widths(conf) -> dict:
    """Words a token of one layer puts in a page of each paged kind."""
    if conf.get("kv_lora_rank"):
        return {"c_kv": conf["kv_lora_rank"]}
    hd = conf["hidden_size"] // conf["num_attention_heads"]
    kv = conf["num_key_value_heads"] * hd
    return {"k": kv, "v": kv}


def tier_check(req, sched, widths: dict, page_tokens: int) -> Tuple[int, int]:
    """``(pages off, words off)`` of one request's tier log against the
    schedule; ``widths``: words a token of a layer puts in a page of each
    kind."""
    import torch

    log = req.tier
    want = dict(sched)
    got = {}
    for key, (step, view) in log.issued.items():
        m = _KEY.search(key)
        got[(int(m.group(1)), m.group(2), int(m.group(3)))] = (step, view,
                                                               key)
    pages_off = sum(1 for k in set(want) | set(got)
                    if k not in want or k not in got
                    or (want[k].issued, want[k].view) != got[k][:2])
    applied = {}
    for keys, step, digests in log.applied:
        for key, d in zip(keys, torch.as_tensor(digests).cpu().tolist()):
            applied.setdefault(key, []).append((step, d))

    def page_words(kind):
        return max(1, page_tokens * req.batch * widths.get(kind, 0))

    words_off = 0
    for k, s in want.items():
        name = got[k][2] if k in got else None
        recs = applied.pop(name, None) if name is not None else None
        if not recs or name not in log.committed:
            words_off += page_words(k[1])
            continue
        exp = digest(views.view_words(torch.from_numpy(
            np.asarray(log.committed[name]).astype(np.int32)), s.view))
        if any(r != (s.issued + 1, exp) for r in recs):
            words_off += page_words(k[1])
    for name in applied:
        m = _KEY.search(name)
        words_off += page_words(m.group(2) if m else "")
    return pages_off, words_off


def gaps(ref_logits, served) -> "torch.Tensor":
    """(B, n): the reference's best logit minus its logit of each served
    token."""
    import torch

    s = torch.as_tensor(served, device=ref_logits.device).long()
    return ref_logits.max(-1).values - ref_logits.gather(-1, s[..., None])[..., 0]


def reference_logits(cell, params, req, sched, numerics="f32"):
    """The reference's logits at every position a served token came from:
    the prompt's last, then each decode step's (B, new_tokens, vocab)."""
    import torch

    ref = cell.reference()
    P, N = req.prompt_len, req.new_tokens
    tokens = np.concatenate([req.prompt, req.tokens[:, :N - 1]], axis=1)
    return ref.forward(cell.conf, params, torch.from_numpy(
        tokens.astype(np.int64)), prompt_len=P,
        out_positions=range(P - 1, P + N - 1), schedule=sched or None,
        page_tokens=cell.traffic["page_tokens"], numerics=numerics)


def check(cell, run, params, seed: int) -> Tuple[bool, List[tuple]]:
    """``(correct, [(name, value, limit), ...])`` over the numbers the
    cell's limits file names; ``requests_checked``'s limit is the least
    number of finished requests replayed, the others' the most a sound
    run reads."""
    t = cell.traffic
    picked = sample(run.requests, seed, t["check"]["sampled_requests"])
    got = readings(cell, picked, params)
    lim = cell.limits
    checks = [(name, got[name], lim[name]) for name in NUMBERS
              if name in lim]
    ok = all(v >= limit if name == "requests_checked" else v <= limit
             for name, v, limit in checks)
    return ok, checks


# every number the check can compare, in the order it prints them
NUMBERS = ("requests_checked", "prefill_gap", "decode_gap", "gap_mean",
           "tier_pages_off", "tier_words_off")


def readings(cell, picked, params, with_control: bool = False) -> dict:
    """The numbers of :data:`NUMBERS` over the sampled requests, and with
    ``with_control`` the control's gaps as ``control_<name>``: the
    reference computed in float8 (one precision below the served bf16)
    in the program's place, whose first-placed token at each served
    position is read by the float32 reference's gap."""
    out = {"requests_checked": len(picked), "tier_pages_off": 0,
           "tier_words_off": 0}
    sums = {}
    for req in picked:
        sched = spill_schedule(cell, req)
        p, w = tier_check(req, sched, paged_widths(cell.conf),
                          cell.traffic["page_tokens"])
        out["tier_pages_off"] += p
        out["tier_words_off"] += w
        ref = reference_logits(cell, params, req, sched)
        served = [("", req.tokens)]
        if with_control:
            ctl = reference_logits(cell, params, req, sched, numerics="fp8")
            served.append(("control_", ctl.argmax(-1).cpu().numpy()))
            del ctl
        for who, tokens in served:
            g = gaps(ref, tokens)
            for name, v in (("prefill_gap", g[:, 0].max()),
                            ("decode_gap", g[:, 1:].max())):
                out[who + name] = max(out.get(who + name, 0.0), float(v))
            n, tot = sums.get(who, (0, 0.0))
            sums[who] = (n + g.numel(), tot + float(g.double().sum()))
            del g
        del ref
    for who, (n, tot) in sums.items():
        out[who + "gap_mean"] = tot / n
    for name in NUMBERS:
        out.setdefault(name, 0.0)
    return out
