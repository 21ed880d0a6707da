"""Verify the multi-pod communication contract from the dry run's
collective records — the reference's ``repro.launch.verify_multipod``.

Claim: on the 2×16×16 mesh the ``pod`` dim is pure data parallelism —
collectives whose group holds ranks of both pods (global ranks below and
at or above 256) appear only in the gradient and optimizer path, never
in the forward's parameter gathers.  The port has no HLO: each record of
:func:`..dryrun.run_cell` carries its group's global ranks, its phase
(``forward``, ``backward``, ``optimizer``) and the line of the port it
comes from.

Usage: PYTHONPATH=src python -m repro_torch.launch.verify_multipod [arch]
"""

from __future__ import annotations

import sys
from collections import Counter


def group_crosses_pods(ranks, pod_size: int = 256) -> bool:
    """Whether a group of global ``ranks`` spans pods."""
    ranks = list(ranks)
    return bool(ranks) and min(ranks) // pod_size != max(ranks) // pod_size


def analyse(records, pod_size: int = 256) -> dict:
    """The records split into ``cross_pod`` (``(op, tag, record)``, the
    tag ``GRAD/OPT`` for a backward or optimizer collective, else
    ``forward?``) and the count ``in_pod``."""
    out = {"cross_pod": [], "in_pod": 0}
    for r in records:
        if group_crosses_pods(r["ranks"], pod_size):
            tag = ("GRAD/OPT" if r["phase"] in ("backward", "optimizer")
                   else "forward?")
            out["cross_pod"].append((r["op"], tag, r))
        else:
            out["in_pod"] += 1
    return out


def report(arch: str, res: dict) -> list:
    """The reference's lines for ``analyse``'s result — the cross-pod
    collectives counted by (kind, tag, op, phase, line of the port) —
    and the verdict, which names the forward ones."""
    lines = [f"[multipod] {arch}: {res['in_pod']} in-pod collectives, "
             f"{len(res['cross_pod'])} cross-pod"]
    by = Counter((r["kind"], tag, op, r["phase"], r["site"])
                 for op, tag, r in res["cross_pod"])
    lines += [f"  {n} x cross-pod {kind} [{tag}] {op} ({phase}) {site}"
              for (kind, tag, op, phase, site), n in sorted(by.items())]
    forward = [f"{op} at {site}" for _, tag, op, _, site in sorted(by)
               if tag != "GRAD/OPT"]
    if res["cross_pod"] and not forward:
        lines.append("[multipod] OK: all cross-pod collectives are in the "
                     "gradient/optimizer path")
    elif not res["cross_pod"]:
        lines.append("[multipod] no cross-pod collectives found (check the "
                     "records)")
    else:
        lines.append("[multipod] WARNING: forward-path cross-pod "
                     "collectives above: " + "; ".join(forward))
    return lines


def main(arch: str = "qwen2-0.5b") -> dict:
    """Trace ``arch`` × train_4k on the 2×16×16 mesh (a fake 512-rank
    world) and print the verdict; returns ``analyse``'s result."""
    from .dryrun import run_cell

    rec = run_cell(arch, "train_4k", True, keep_records=True)
    res = analyse(rec["collective_records"])
    for line in report(arch, res):
        print(line, flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "qwen2-0.5b")
