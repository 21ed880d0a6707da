"""Port vs reference: the synthetic data stream and checkpoints.

The tests of ``tests/test_data_checkpoint.py`` on the port, then:
* batches byte-identical to the reference's stream for several
  ``(seed, step, rank, world)``;
* checkpoints interchange bit for bit: a train state the reference's
  ``CheckpointManager`` writes (bf16 params and residuals, f32 and bf16
  moments, the int32 step) restores in the port to the same bytes, and
  one the port writes restores in the reference;
* the port's train loop restarts exactly: 9 steps straight == 6 steps,
  a restart and 3 more, loss for loss and byte for byte in the final
  state (no tolerance: the CPU sums in one order every run).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RManager  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import ShardedTokenStream as RStream  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, restore_pytree, save_pytree,
)
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig, ShardedTokenStream, make_train_iterator,
)
from repro_torch.tree import leaves_with_paths  # noqa: E402

CFG = DataConfig(vocab=512, seq_len=64, global_batch=8, seed=7)


def _bytes(t) -> tuple:
    """dtype name, shape and raw bytes of a tensor or an array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        return name, arr.shape, arr.tobytes()
    arr = np.asarray(t)
    return arr.dtype.name, arr.shape, arr.tobytes()


# ---------------------------------------------------------------------------
# tests/test_data_checkpoint.py on the port
# ---------------------------------------------------------------------------

def test_stream_deterministic():
    a = ShardedTokenStream(CFG).batch_at(3)
    b = ShardedTokenStream(CFG).batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_stream_steps_differ():
    s = ShardedTokenStream(CFG)
    assert not np.array_equal(s.batch_at(0)["tokens"], s.batch_at(1)["tokens"])


def test_sharded_ranks_partition_global_batch():
    s = ShardedTokenStream(CFG)
    whole = s.batch_at(5)["tokens"]
    parts = [s.batch_at(5, rank=r, world=4)["tokens"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_labels_shift():
    b = ShardedTokenStream(CFG).batch_at(0)
    assert b["tokens"].shape == (8, 64) and b["labels"].shape == (8, 64)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_world_must_divide_the_batch():
    with pytest.raises(ValueError, match="not divisible"):
        ShardedTokenStream(CFG).batch_at(0, rank=0, world=3)


def test_pytree_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"c": torch.ones(4, dtype=torch.bfloat16),
              "step": torch.tensor(3, dtype=torch.int32)},
    }
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    out = restore_pytree(tree, d, device="cpu")
    for (ka, x), (kb, y) in zip(leaves_with_paths(tree),
                                leaves_with_paths(out)):
        assert ka == kb and _bytes(x) == _bytes(y)


def test_manager_save_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(3, 3)}
    for step in (2, 4, 6):
        mgr.save(step, {"w": tree["w"] + step}, extra={"loss": 1.0 / step})
    assert mgr.steps() == [4, 6]     # retention
    restored, manifest = mgr.restore(tree, device="cpu")
    assert manifest["step"] == 6
    assert torch.equal(restored["w"], torch.full((3, 3), 6.0))


def test_manager_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_save_snapshots_before_returning(tmp_path):
    """The train step writes its tensors in place: an async save holds a
    copy taken when ``save`` returned, even of a CPU tensor."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones(1000)
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore({"w": w}, device="cpu")
    assert torch.equal(restored["w"], torch.ones(1000))


def test_async_save_failure_is_raised_by_wait(tmp_path, monkeypatch):
    def broken(tree, directory):
        raise OSError("disk full")
    monkeypatch.setattr(tmanager, "save_pytree", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.steps() == [] and not os.listdir(tmp_path)


def test_no_partial_checkpoint_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / ".tmp_crashed")
    (tmp_path / ".tmp_crashed" / "arrays.npz").write_bytes(b"junk")
    os.makedirs(tmp_path / "step_00000009")  # dir without manifest
    assert mgr.steps() == []


def test_restore_missing_leaf_raises(tmp_path):
    save_pytree({"a": torch.ones(2)}, str(tmp_path))
    with pytest.raises(KeyError, match="missing leaves"):
        restore_pytree({"a": 0, "b": {"c": 0}}, str(tmp_path), device="cpu")


def test_train_iterator_places_the_stream(tmp_path):
    it = make_train_iterator(CFG, device="cpu", start_step=4)
    step, batch = next(it)
    want = ShardedTokenStream(CFG).batch_at(4)
    assert step == 4 and batch["tokens"].dtype == torch.int32
    for k in ("tokens", "labels"):
        assert np.array_equal(batch[k].numpy(), want[k])
    assert next(it)[0] == 5


@pytest.mark.slow   # full train loop (model forward + backward)
def test_train_restart_bitexact(tmp_path):
    """9 steps straight == 6 steps + restart + 3 steps (fault tolerance),
    exactly: losses and the final state's bytes."""
    from repro_torch.launch.train import train

    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(arch="qwen2-0.5b", smoke=True, seq_len=32, global_batch=2,
              ckpt_every=3, log_every=100, device="cpu")
    straight = train(steps=9, ckpt_dir=d1, **kw)
    train(steps=6, ckpt_dir=d2, **kw)
    resumed = train(steps=9, ckpt_dir=d2, **kw)
    assert resumed["start_step"] == 6
    assert resumed["losses"] == straight["losses"][-3:]
    for name in ("params", "opt_state", "err"):
        a, b = leaves_with_paths(straight[name]), leaves_with_paths(
            resumed[name])
        assert [k for k, _ in a] == [k for k, _ in b]
        assert all(_bytes(x) == _bytes(y) for (_, x), (_, y) in zip(a, b))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,rank,world", [
    (0, 0, 0, 1), (7, 3, 0, 1), (7, 3, 2, 4), (11, 1000, 1, 2),
    (123, 5, 7, 8)])
def test_batches_byte_identical_to_reference(seed, step, rank, world):
    kw = dict(vocab=50257, seq_len=96, global_batch=8, seed=seed)
    want = RStream(RDataConfig(**kw)).batch_at(step, rank, world)
    got = ShardedTokenStream(DataConfig(**kw)).batch_at(step, rank, world)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def _reference_state():
    """A train state as the reference's loop checkpoints it: bf16 params,
    f32 ``mu``, bf16 ``nu`` (as with bf16 moments), the int32 step and
    bf16 residuals — every dtype a checkpoint holds."""
    rng = np.random.default_rng(5)
    params = {"embed": jnp.asarray(rng.standard_normal((16, 8)), jnp.bfloat16),
              "layers": {"w": jnp.asarray(rng.standard_normal((2, 8, 8)),
                                          jnp.bfloat16),
                         "A_log": jnp.asarray(rng.standard_normal((2, 4)),
                                              jnp.float32)}}
    return {"params": params,
            "opt": {"mu": jax.tree.map(lambda p: p.astype(jnp.float32) * 0.1,
                                       params),
                    "nu": jax.tree.map(lambda p: (p * p).astype(jnp.bfloat16),
                                       params),
                    "step": jnp.int32(12)},
            "err": jax.tree.map(lambda p: (p * 0.01).astype(jnp.bfloat16),
                                params)}


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in flat}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _reference_state()
    RManager(str(tmp_path)).save(12, state, extra={"arch": "x", "loss": 1.5})
    got, manifest = CheckpointManager(str(tmp_path)).restore(
        jax.tree.map(lambda _: 0, state), device="cpu")
    assert manifest == {"step": 12, "arch": "x", "loss": 1.5}
    want = _ref_leaves(state)
    flat = leaves_with_paths(got)
    assert [k for k, _ in flat] == list(want)        # the reference's order
    assert "opt/mu/layers/w" in want and "opt/step" in want
    for k, t in flat:
        assert _bytes(t) == _bytes(want[k]), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = jax.tree.map(
        lambda a: (torch.from_numpy(np.asarray(a).view(np.int16).copy())
                   .view(torch.bfloat16) if a.dtype == jnp.bfloat16
                   else torch.from_numpy(np.array(a))), _reference_state())
    CheckpointManager(str(tmp_path)).save(12, state, extra={"arch": "x"})
    with open(tmp_path / "step_00000012" / "dtypes.json") as f:
        assert set(json.load(f)) == {
            k for k, t in leaves_with_paths(state)
            if t.dtype == torch.bfloat16}
    got, manifest = RManager(str(tmp_path)).restore(_reference_state())
    assert manifest == {"step": 12, "arch": "x"}
    mine = dict(leaves_with_paths(state))
    for k, leaf in _ref_leaves(got).items():
        assert _bytes(leaf) == _bytes(mine[k]), k
