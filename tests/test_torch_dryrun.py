"""The port's dry run (``repro_torch.launch.dryrun``) against hand-made
collectives, the reference's trip counts, full traces and real-rank runs.

* The accounting on collectives of every kind, ``c10d`` and functional,
  a tuple result included (``test_collective_bytes_parses_ops`` of the
  reference's, on ops in place of HLO text): kinds, counts, result
  bytes, the group's global ranks and the phase; an unknown collective
  raises.
* ``scan_trip_count`` equal to the reference's for every arch (the
  reference's module loaded as ``tests/test_dryrun_parsing.py`` loads
  it).
* The decode-attention wrapper on the meta device: shapes checked, an
  empty f32 output, nothing launched.
* deepseek-v2-lite-16b's train step (the static capacity dispatch of
  the expert-parallel MoE) traced on meta under a fake (2, 2) world.
* The trip-count correction equal to a full trace at smoke width: a
  4-layer stack (train and decode), a 64-token Mamba1 prompt (prefill
  and train) and a hybrid of 14 layers (prefill and train): FLOPs,
  bytes, collective bytes and counts and kernel calls exactly (the
  peaks are estimates).
* A meta run against a real-rank run on the CPU of the same smoke cell:
  the collectives by kind, counts and bytes, equal.

Every fake world is started and destroyed by the call that needs it.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_dryrun_cases import smoke_overrides  # noqa: E402

META = torch.device("meta")


def _world_and_group():
    """A fake world of 4 and the group of ranks (0, 2)."""
    return dryrun.fake_world(4)


def test_collective_accounting_every_kind():
    import torch.distributed._functional_collectives as funcol

    with _world_and_group():
        grp = dist.new_group([0, 2])
        acc = dryrun.Accounting("cpu")
        x = torch.zeros(8)
        with acc:
            dist.all_gather_into_tensor(torch.empty(16), x, group=grp)
            dist.all_gather([torch.empty(8) for _ in range(2)], x, group=grp)
            dist.all_reduce(torch.zeros(3))
            dist.reduce_scatter_tensor(torch.empty(4), x, group=grp)
            dist.all_to_all_single(torch.empty(8), x, group=grp)
            dist.send(torch.zeros(5), dst=1)
            funcol.all_gather_tensor(x, 0, grp).wait()
            funcol.all_reduce(torch.zeros(6, dtype=torch.bfloat16), "sum",
                              grp).wait()
            funcol.reduce_scatter_tensor(x, "sum", 0, grp).wait()
            funcol.all_to_all_single(x, None, None, grp).wait()
            # a tuple result: both tensors count
            for t in funcol.all_reduce_coalesced(
                    [torch.zeros(64, dtype=torch.bfloat16),
                     torch.zeros(32, dtype=torch.bfloat16)], "sum", grp):
                t.wait()
        c = acc.collectives
    assert c["n_all-gather"] == 3
    assert c["all-gather"] == 16 * 4 + 2 * 8 * 4 + 16 * 4
    assert c["n_all-reduce"] == 3
    assert c["all-reduce"] == 3 * 4 + 6 * 2 + 64 * 2 + 32 * 2
    assert c["n_reduce-scatter"] == 2 and c["reduce-scatter"] == 2 * 4 * 4
    assert c["n_all-to-all"] == 2 and c["all-to-all"] == 2 * 8 * 4
    assert c["n_collective-permute"] == 1
    assert c["collective-permute"] == 5 * 4
    assert c["total"] == sum(c[k] for k in dryrun.COLLECTIVES)
    assert len(acc.records) == 11
    by_op = {r["op"]: r for r in acc.records}
    assert by_op["c10d.allreduce_"]["ranks"] == [0, 1, 2, 3]
    assert by_op["c10d._allgather_base_"]["ranks"] == [0, 2]
    assert by_op["_c10d_functional.all_gather_into_tensor"]["ranks"] == [0, 2]
    assert {r["phase"] for r in acc.records} == {"forward"}


def test_collective_accounting_ignores_compute_and_raises_on_unknown():
    with _world_and_group():
        acc = dryrun.Accounting("cpu")
        with acc:
            torch.ones(4, 4) @ torch.ones(4, 4)
        assert acc.collectives == dryrun.empty_collectives()
        assert acc.flops == 2 * 4 * 4 * 4
        with pytest.raises(NotImplementedError, match="broadcast"):
            with dryrun.Accounting("cpu"):
                dist.broadcast(torch.zeros(2), src=0)


class _ReduceInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g)
        return g


def test_collective_phases():
    from repro_torch.optim.grad_compress import _global_amax

    with _world_and_group():
        acc = dryrun.Accounting("cpu")
        x = torch.ones(3, requires_grad=True)
        with acc:
            _ReduceInBackward.apply(x).sum().backward()
            _global_amax([(torch.ones(2), torch.zeros(2))], [True])
            dist.all_reduce(torch.zeros(1))
    assert [r["phase"] for r in acc.records] == ["backward", "optimizer",
                                                "forward"]
    assert acc.records[1]["site"].startswith("optim/grad_compress.py:")


def test_collective_records_on_a_mesh_name_their_groups():
    """On a (2, 2) mesh of a fake world the model dim's groups are ranks
    (0, 1) and the data dim's (0, 2), as the mesh lays them out."""
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", False,
                          overrides=smoke_overrides("qwen2-0.5b"),
                          mesh_shape=(2, 2), keep_records=True)
    groups = {tuple(r["ranks"]) for r in rec["collective_records"]}
    assert groups == {(0, 1), (0, 2), (0, 1, 2, 3)}
    gathers = [r for r in rec["collective_records"]
               if r["kind"] == "all-gather"]
    assert {r["phase"] for r in gathers} == {"forward"}
    assert rec["collectives"]["n_all-gather"] == len(gathers)
    assert rec["argument_size_in_bytes"] == 5286404


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_scan_trip_count_equals_reference(arch):
    from test_dryrun_parsing import DR

    assert dryrun.scan_trip_count(ARCHS[arch]) == DR.scan_trip_count(
        DR.ARCHS[arch])


def test_decode_attention_on_meta_launches_nothing():
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import decode_attention

    q = torch.empty((8, 14, 64), dtype=torch.bfloat16, device=META)
    k = torch.empty((8, 32768, 2, 64), dtype=torch.bfloat16, device=META)
    before = dict(build.LAUNCHES)
    out = decode_attention(q, k, k, 32768, 0.125)
    assert out.device == META and out.dtype == torch.float32
    assert out.shape == (8, 14, 64)
    assert dict(build.LAUNCHES) == before
    with pytest.raises(ValueError):
        decode_attention(q, k, k, 32769)
    with pytest.raises(ValueError):
        decode_attention(q[:4], k, k, 1)
    with pytest.raises(TypeError):
        decode_attention(q.float(), k, k, 1)


def test_deepseek_train_step_traces_on_meta():
    """The expert-parallel MoE's dispatch and combine have static shapes,
    so the train step traces on meta: a MoE layer's two all-to-alls in
    the forward and their two in the backward (remat is off at smoke
    width)."""
    cfg = smoke_config(ARCHS["deepseek-v2-lite-16b"])
    rec = dryrun.run_cell("deepseek-v2-lite-16b", "train_4k", False,
                          overrides=smoke_overrides("deepseek-v2-lite-16b"),
                          mesh_shape=(2, 2))
    moe_layers = cfg.n_layers - cfg.first_dense
    assert rec["collectives"]["n_all-to-all"] == 4 * moe_layers
    assert rec["collectives"]["all-to-all"] > 0
    assert rec["flops"] > 0 and rec["temp_size_in_bytes"] > 0


# (arch, n_layers, shape, seq, rows, layers cut, scan steps cut)
EXTRAPOLATED = [
    ("qwen2-0.5b", 4, "train_4k", 64, 8, True, None),
    ("qwen2-0.5b", 4, "decode_32k", 64, 8, True, None),
    ("falcon-mamba-7b", 4, "prefill_32k", 64, 4, True, (2, 3)),
    ("falcon-mamba-7b", 4, "train_4k", 64, 4, True, (2, 3)),
    ("zamba2-7b", 14, "prefill_32k", 64, 4, True, (2, 3)),
    ("zamba2-7b", 14, "train_4k", 64, 4, True, (2, 3)),
]


@pytest.mark.parametrize("arch,n,shape,seq,rows,layers,steps", EXTRAPOLATED,
                         ids=[f"{c[0]}-{c[2]}" for c in EXTRAPOLATED])
def test_extrapolation_equals_full_trace(arch, n, shape, seq, rows, layers,
                                         steps):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), n_layers=n)
    sh = dataclasses.replace(SHAPES[shape], seq_len=seq, global_batch=rows)
    with dryrun.fake_world(4):
        mesh, _ = dryrun._mesh(False, (2, 2), META)
        acc, outb, _, _, out, args = dryrun.trace(cfg, sh, mesh, META)
        full = dryrun._summary(acc, outb)
        del out, args
        got, _, _ = dryrun.extrapolated_trace(cfg, sh, mesh, META, layers,
                                              steps)
    exact = {k: v for k, v in full.items() if k not in dryrun._PEAKS}
    assert {k: got[k] for k in exact} == exact
    assert exact["flops"] > 0 and exact["collectives/total"] > 0
    if shape == "decode_32k":
        assert exact["kernel_calls"] == n


@pytest.mark.parametrize("shape", ["decode_32k", "train_small"])
def test_meta_and_real_rank_on_cpu_give_the_same_collectives(shape):
    """The same smoke cell traced on meta and run with real tensors on
    the CPU as rank 0: the same program, so the same collectives; the
    train cell cut to 8 x 64 tokens so the CPU run stays small."""
    cell = (SHAPES[shape] if shape in SHAPES else dataclasses.replace(
        SHAPES["train_4k"], seq_len=64, global_batch=8))
    kw = dict(overrides=smoke_overrides("qwen2-0.5b"), mesh_shape=(2, 2))
    meta = dryrun.run_cell("qwen2-0.5b", cell, False, **kw)
    real = dryrun.run_cell("qwen2-0.5b", cell, False, device="cpu", **kw)
    assert real["collectives"] == meta["collectives"]
    assert real["kernel_calls"] == meta["kernel_calls"]
    assert real["argument_size_in_bytes"] == meta["argument_size_in_bytes"]
    assert real["real_rank"]["step_s"] > 0


SMALL = ["--set", "n_layers=1", "--set", "d_model=128", "--set",
         "n_heads=4", "--set", "n_kv_heads=2", "--set", "head_dim=32",
         "--set", "d_ff=256", "--set", "vocab=512"]


@pytest.mark.parametrize("real", [False, True], ids=["meta", "real-cpu"])
def test_cli_writes_ok_records(tmp_path, capsys, real):
    """``main`` with the reference's flags (``--set``, ``--mesh-shape``,
    ``--out``), and ``--real-rank --cpu``: an ``ok`` record, the
    reference's per-cell and summary lines."""
    import json

    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                 "--mesh-shape", "2,2", "--out", str(out)] + SMALL
                + (["--real-rank", "--cpu"] if real else []))
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["mesh"] == "2x2" and rec["kernel_calls"] == 1
    assert rec["overrides"]["d_model"] == 128
    assert ("real_rank" in rec) == real
    text = capsys.readouterr().out
    assert "[dryrun] qwen2-0.5b × decode_32k × 2x2 ..." in text
    assert "[dryrun] 1/1 cells traced" in text
