"""The port's multi-pod check (``repro_torch.launch.verify_multipod``)
against the reference's.

* ``group_crosses_pods`` on every dim group of a (2, 16, 16) (pod, data,
  model) mesh — ``pod``, ``data``, ``model`` and ``(pod, data)``
  flattened — agrees with the reference's, which is given the same
  groups in its explicit ``{…}`` form one by one and in its iota form
  all together.
* ``analyse`` on the records of a fake (2, 2, 2) world at smoke width,
  two pods of 4 ranks: the gradient reductions over ``pod`` (and the
  optimizer's world-wide ones) tagged ``GRAD/OPT``, the loss's scalar
  ``reduce_`` in ``launch/steps.py`` the one ``forward?``; no parameter
  gather crosses a pod.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.verify_multipod import (  # noqa: E402
    analyse, group_crosses_pods, report,
)
from torch_dryrun_cases import smoke_overrides  # noqa: E402

IDS = np.arange(512).reshape(2, 16, 16)
# each dim's groups, and the reference's iota form of the same groups
DIM_GROUPS = {
    "pod": ([IDS[:, d, m] for d in range(16) for m in range(16)],
            "[256,2]<=[2,256]T(1,0)"),
    "data": ([IDS[p, :, m] for p in range(2) for m in range(16)],
             "[32,16]<=[2,16,16]T(0,2,1)"),
    "model": ([IDS[p, d, :] for p in range(2) for d in range(16)],
              "[32,16]<=[512]"),
    "pod,data": ([IDS[:, :, m].reshape(-1) for m in range(16)],
                 "[16,32]<=[32,16]T(1,0)"),
}


@pytest.mark.parametrize("dims", sorted(DIM_GROUPS))
def test_group_crosses_pods_agrees_with_reference(dims):
    from repro.launch.verify_multipod import group_crosses_pods as ref

    groups, iota = DIM_GROUPS[dims]
    for g in groups:
        ranks = [int(r) for r in g]
        assert group_crosses_pods(ranks) == ref(
            "{{" + ",".join(map(str, ranks)) + "}}")
    assert any(group_crosses_pods([int(r) for r in g]) for g in groups) \
        == ref(iota)
    assert any(group_crosses_pods([int(r) for r in g]) for g in groups) \
        == ("pod" in dims)


def test_analyse_tags_the_gradient_path_and_names_the_loss_reduce():
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", True,
                          overrides=smoke_overrides("qwen2-0.5b"),
                          mesh_shape=(2, 2, 2), keep_records=True)
    records = rec["collective_records"]
    res = analyse(records, pod_size=4)
    assert res["in_pod"] + len(res["cross_pod"]) == len(records)
    tags = {}
    for op, tag, r in res["cross_pod"]:
        tags.setdefault(tag, []).append(r)
    forward = tags.get("forward?", [])
    assert len(forward) == 1
    assert forward[0]["op"] == "c10d.allreduce_"
    assert forward[0]["site"].startswith("launch/steps.py:")
    assert forward[0]["site"].endswith("loss_and_grads")
    grad = tags["GRAD/OPT"]
    assert any(r["phase"] == "backward" and r["kind"] == "all-reduce"
               for r in grad)
    assert any(r["phase"] == "optimizer" for r in grad)
    assert not any(r["kind"] == "all-gather" for _, _, r in res["cross_pod"])
    lines = report("qwen2-0.5b", res)
    assert lines[0].endswith(f"{res['in_pod']} in-pod collectives, "
                             f"{len(res['cross_pod'])} cross-pod")
    assert "WARNING" in lines[-1]
