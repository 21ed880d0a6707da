"""Port on a mesh vs the port on one rank and the reference on the same
mesh: ``train(mesh=...)``, its stored shards, gradient compression and
the elastic restart.

qwen2-0.5b and deepseek-v2-lite-16b at smoke width, 2 steps of 4 x 32
tokens from the port's seed-0 draw (compression on), on 4 gloo ranks at
(data, model) (2, 2); ``test_torch_mesh_pod.py`` runs the same checks at
(pod, data, model) (2, 1, 2) (a module each, so each has its own
reference subprocess and both fit a worker's share of the time).  The reference
runs ``make_train_step(rules=...)`` jitted on the same meshes of host
devices, from the same params and batches (labels aligned with the
positions), in one subprocess for the module (``tests/torch_mesh_ref.py``).

Bounds:
* against the port's single-rank ``train``: losses within 1e-4
  relative; at least 99 % of the updated params bit-equal and every
  element within one bf16 ulp of itself or 2 x (the steps' lr) — the
  mesh sums each gradient over the batch ranks in bf16, other roundings
  than one device's;
* against the reference on the same mesh: ``test_torch_train_loop.py``'s
  bounds — each loss within 1e-2, the params as above;
* each rank's stored bytes of params, moments and error buffers equal
  its shards' sizes under the rules, exactly;
* compression of a sharded gradient tree equals the same tree's whole,
  bit for bit (the int8 scale is the leaf's max over every rank);
* remat on a mesh (each layer's gathers and ``all_to_all`` s recomputed
  in the backward) bit-equal to remat off; the train iterator's
  per-rank rows the stream's;
* elastic restart: 2 steps on (2, 2) and a checkpoint, restored onto
  (4, 1), onto (4, 1) from the reference's own save of it, and onto one
  rank, then 2 more steps: the restored state byte-identical to the
  saved one, the losses within 1e-4 relative of an uninterrupted 4-step
  (2, 2) run; the reference's ``CheckpointManager`` reads the port's
  mesh checkpoint byte for byte.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from torch_mesh_cases import (  # noqa: E402
    TRAIN_ARCHS, check_train_cell, finish_reference, mesh_world, run_world,
    stop_reference, to_np, train_cells,
)

pytestmark = pytest.mark.slow   # model-forward module

MESH = "2x2"
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.checkpoint import CheckpointManager as RManager
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves_with_paths

    tmp = tmp_path_factory.mktemp("mesh_train")
    ckpt = tmp / "ckpt"
    qwen = TRAIN_ARCHS[0]
    ref, single, port = train_cells(
        tmp, MESH, (2, 2), ("data", "model"),
        [("train", "straight", qwen, 4, None), ("remat",), ("data",)],
        ckpt=str(ckpt))
    try:
        # the reference reads the port's mesh checkpoint, and saves it again
        spec = _spec()
        template = CheckpointManager(str(ckpt)).restore(
            {"params": spec, "opt": {"mu": spec, "nu": spec, "step": 0},
             "err": spec}, device="cpu")[0]
        saved = {k: to_np(v) for k, v in leaves_with_paths(template)}
        rtree = jax.tree.map(lambda t: _jnp(to_np(t)), template)
        rstate, _ = RManager(str(ckpt)).restore(rtree, step=2)
        read_by_ref = {"/".join(str(p.key) for p in path): _np(leaf) for path, leaf
                       in jax.tree_util.tree_flatten_with_path(rstate)[0]}
        ref_ckpt = tmp / "ref_ckpt"
        RManager(str(ref_ckpt)).save(2, rstate)
        for name in ("ckpt41", "ckpt1"):
            shutil.copytree(ckpt, tmp / name)
        resumed = run_world(
            mesh_world, 4, tmp / "w4x1", (4, 1), ("data", "model"),
            [("restore", "restored", qwen, str(tmp / "ckpt41"), 2),
             ("train", "resumed", qwen, 4, str(tmp / "ckpt41")),
             ("train", "resumed_ref", qwen, 4, str(ref_ckpt))])
        one = train(arch=qwen, steps=4, ckpt_dir=str(tmp / "ckpt1"), smoke=True,
                    seq_len=32, global_batch=4, seed=0, device="cpu",
                    log_every=1000)
        return {"single": single, "port": port, "ref": finish_reference(ref),
                "resumed": resumed, "saved": saved, "read_by_ref": read_by_ref,
                "one": {"losses": one["losses"], "start": one["start_step"]}}
    finally:
        stop_reference(ref)


def _spec():
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.model import schema

    return schema(smoke_config(ARCHS[TRAIN_ARCHS[0]]))


def _jnp(a):
    return jax.numpy.asarray(a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16
                             else a)


def _np(leaf):
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_train_matches_single_rank_and_reference(runs, arch):
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


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_remat_on_a_mesh_is_bit_equal(runs, arch):
    """Remat recomputes each layer in the backward, its parameter gathers
    and (deepseek) its ``all_to_all`` s with it, in the same order on
    every rank: loss and gradients bit-equal to remat off."""
    for out in runs["port"]:
        r = out["remat"][arch]
        assert r["losses"][0] == r["losses"][1] and r["differ"] == []


def test_train_iterator_places_each_ranks_rows(runs):
    """``make_train_iterator(batch_sharding=)``: each rank draws its rows
    of the stream (rank r of 2 along ``data``; both ``model`` ranks the
    same rows) as a DTensor of the global (B, S)."""
    got = [out["data"] for out in runs["port"]]
    assert [g["rows"] for g in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert all(all(g["ok"]) for g in got)


@pytest.mark.parametrize("run", ["resumed", "resumed_ref", "one"])
def test_elastic_restart_continues_the_run(runs, run):
    """Saved on (2, 2) after 2 steps; resumed on (4, 1) (from the port's
    checkpoint and from the reference's save of it) and on one rank: the
    last 2 losses of an uninterrupted (2, 2) run."""
    straight = runs["port"][0]["straight"]["losses"]
    got = runs["one"] if run == "one" else runs["resumed"][0][run]
    assert got["start"] == 2 and len(got["losses"]) == 2
    np.testing.assert_allclose(got["losses"], straight[2:], rtol=LOSS_RTOL,
                               atol=0)


def test_restored_state_is_byte_identical(runs):
    """The (2, 2) checkpoint restored onto (4, 1) (every rank holding
    DTensors there), gathered whole: the saved bytes; and the reference
    reads the same bytes from the port's checkpoint."""
    out = runs["resumed"]
    assert all(o["restored"]["sharded"] > 0 for o in out)
    got = out[0]["restored"]["state"]
    saved = runs["saved"]
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        r = runs["read_by_ref"][k]
        assert r.dtype == v.dtype and np.array_equal(r, v), k
