"""Port on a (pod, data, model) (2, 1, 2) mesh vs the port on one rank
and the reference on the same mesh: ``train(mesh=...)``, its stored
shards and gradient compression — ``test_torch_mesh_train.py``'s checks
at the multi-pod layout, where the batch splits over ``pod`` and
``data`` and gradients reduce over both.  qwen2-0.5b and
deepseek-v2-lite-16b at smoke width, 2 steps of 4 x 32 tokens, 4 gloo
ranks; bounds as there.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_mesh_cases import (  # noqa: E402
    TRAIN_ARCHS, check_train_cell, finish_reference, stop_reference,
    train_cells,
)

pytestmark = pytest.mark.slow   # model-forward module

MESH = "2x1x2"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_pod")
    ref, single, port = train_cells(tmp, MESH, (2, 1, 2),
                                    ("pod", "data", "model"))
    try:
        return {"single": single, "port": port,
                "ref": finish_reference(ref)}
    finally:
        stop_reference(ref)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_pod_mesh_train_matches_single_rank_and_reference(runs, arch):
    check_train_cell(runs["single"], runs["port"], runs["ref"], arch, MESH)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_each_rank_stores_its_shards(runs, arch):
    for rank, out in enumerate(runs["port"]):
        r = out[f"{arch}/{MESH}"]
        assert r["stored"] == r["want"], rank


def test_sharded_compression_equals_single_rank(runs):
    for out in runs["port"]:
        assert out["compress"]["bad"] == []
        assert out["compress"]["sharded"] > 0
