"""The mesh train step as a CUDA graph captures it, checked on the CPU.

On a card ``TrainGraph`` captures the mesh step once a run (DTensor and
NCCL collectives included) and replays it; the CPU never captures.  What
a capture needs of the step can be checked here all the same, on gloo
ranks: each step runs under ``torch_mesh_cases.StepAudit`` (a dispatch
mode that sees the local ops under DTensor), which records

* a read of a device value on the host, an op whose output shape
  depends on the data, and a copy between devices — none may occur;
* every collective in order — the warm-up step must issue what the
  captured step issues, and every rank the same sequence (a rank that
  issued another would deadlock the capture on a card).

qwen2-0.5b and deepseek-v2-lite-16b (its expert-parallel MoE) at smoke
width, 3 steps of 4 x 32 tokens (the warm-up, the step a card captures
and a replay), on one rank at (data, model) (1, 1) and two at (1, 2)
and (2, 1).  On gloo ``train(mesh=...)`` stays eager
(``capture_s`` None) and equals the plain ``make_train_step`` loop bit
for bit, as a ``TrainGraph`` run does.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_cases as cases  # noqa: E402

# (data, model) meshes by world size: each world one spawn
WORLDS = {1: [(1, 1)], 2: [(1, 2), (2, 1)]}
CASES = [(arch, shape) for shapes in WORLDS.values() for shape in shapes
         for arch in cases.TRAIN_ARCHS]
IDS = [f"{arch}-{shape[0]}x{shape[1]}" for arch, shape in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Per mesh shape, its world's ranks' results of
    :func:`torch_mesh_cases.graph_case` (keyed by ``(shape, arch)``)."""
    out = {}
    for n, shapes in WORLDS.items():
        res = cases.run_world(cases.graph_case, n,
                              tmp_path_factory.mktemp(f"w{n}"), shapes,
                              timeout=240)
        for shape in shapes:
            out[shape] = res
    return out


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_mesh_step_takes_no_host_sync(worlds, arch, shape):
    for rank, res in enumerate(worlds[shape]):
        for i, audit in enumerate(res[shape, arch]["audits"]):
            assert audit["faults"] == [], (rank, i)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_mesh_step_collectives_alike_across_steps_and_ranks(worlds, arch,
                                                            shape):
    seqs = [[a["collectives"] for a in res[shape, arch]["audits"]]
            for res in worlds[shape]]
    for rank, steps in enumerate(seqs):
        assert all(s == steps[0] for s in steps), rank
    assert all(s == seqs[0] for s in seqs)
    ops = seqs[0][0]
    if shape == (1, 1):
        # DTensor and the port's helpers skip mesh dims of size 1: what is
        # left are the global norm's and the compression scale's
        # all-reduces on the default group
        assert [(op, size) for op, _, size in ops] == \
            [("c10d.allreduce_", 1)] * 2
    else:
        assert ops and {size for _, _, size in ops} <= {2, None}
        assert any(op.startswith("_c10d_functional.") for op, _, _ in ops)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_on_gloo_stays_eager_and_equals_the_step_loop(worlds, arch,
                                                            shape):
    for rank, res in enumerate(worlds[shape]):
        r = res[shape, arch]
        assert not r["captures"] and not r["graph"], rank
        assert r["capture_s"] is None, rank
        assert r["graph_eq"] and r["train_eq"], rank


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_mesh_state_keeps_its_storage(worlds, arch, shape):
    """Every state leaf's local shard is written in place, as a donated
    buffer is: a graph replays into the storage it captured."""
    for rank, res in enumerate(worlds[shape]):
        assert res[shape, arch]["storage_kept"], rank


def _faults(fn):
    audit = cases.StepAudit()
    with audit:
        fn()
    return [kind for kind, _, _ in audit.faults]


@pytest.mark.parametrize("kind,fn", [
    ("host read", lambda x: float(x.sum())),
    ("host read", lambda x: bool((x > 0).any())),
    ("data-dependent shape", lambda x: x.nonzero()),
    ("data-dependent shape", lambda x: x[x > 0]),
    ("copy between devices", lambda x: x.to("meta")),
], ids=["float", "bool", "nonzero", "mask", "to-device"])
def test_step_audit_finds_what_a_capture_cannot_take(kind, fn):
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    assert _faults(lambda: fn(x)) == [kind]


def test_step_audit_lets_host_scalars_and_static_ops_pass():
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([2, 0])

    def step():
        s = torch.tensor(0.125, dtype=torch.bfloat16)    # a host scalar
        float(s * 2)
        y = x[idx] * s
        torch.nn.functional.one_hot(idx, 3)     # checks range on the CPU only
        return y.sum()

    assert _faults(step) == []
