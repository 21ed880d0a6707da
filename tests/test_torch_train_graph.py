"""Port vs reference: the train step as the reference compiles it —
``jax.jit(train_step, donate_argnums=(0, 1, 2))`` — and the port's
:class:`repro_torch.launch.train.TrainGraph`, whose step is the code a
card shares with the CPU (on the CPU it runs eagerly; the capture and
the replay are the card tests' in ``test_torch_kernels_gpu.py``).

* the wrapper's step against the reference's donated, jitted step with
  gradient compression, for every family the port trains — qwen2-0.5b
  (GQA), deepseek-v2-lite-16b (MLA + MoE), falcon-mamba-7b (Mamba1),
  zamba2-7b (the Mamba2 hybrid), hubert-xlarge (encoder-only) and
  llava-next-34b (a frontend) — at smoke width over three batches, the
  same bf16 embeds fed to both for the embeds-fed models: every step's
  loss within 1e-2, ``grad_norm`` within 3 %, the optimizer's step and
  lr equal; the params after three steps bit-equal on at least 99 % of
  all elements, and each within one bf16 ulp or ``2 * (the three
  steps' lr)`` of the reference's — the bounds of
  ``test_torch_train_loop.py::test_train_step_matches_reference``;
* donation: every state tensor keeps its storage across the steps, and
  the state and metrics equal the plain ``make_train_step`` step's bit
  for bit;
* a batch of another shape or dtype raises ``ValueError``;
* ``train()`` on the CPU: the history and state of a loop of the plain
  step;
* remat stashes no RNG state (a capture cannot read the card's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as rsteps  # noqa: E402
from repro.optim import init as ropt_init  # noqa: E402
from repro.optim.grad_compress import init_error_feedback as rerr  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.data import DataConfig, ShardedTokenStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import init as opt_init  # noqa: E402
from repro_torch.optim.grad_compress import init_error_feedback  # noqa: E402
from repro_torch.tree import leaves_with_paths, map_tree  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

SEQ, BATCH, STEPS = 32, 2, 3
FAMILIES = ["qwen2-0.5b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
            "zamba2-7b", "hubert-xlarge", "llava-next-34b"]


def _batches(cfg, n=STEPS, seed=1):
    """``n`` batches for both packages: tokens (or bf16 embeds) and
    labels aligned with the positions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        rb = {"labels": jnp.asarray(toks)}
        tb = {"labels": torch.from_numpy(toks)}
        if cfg.uses_tokens:
            rb["tokens"] = jnp.asarray(toks)
            tb["tokens"] = torch.from_numpy(toks)
        else:
            emb = jnp.asarray(rng.standard_normal((BATCH, SEQ, cfg.d_model)),
                              jnp.bfloat16)
            rb["embeds"] = emb
            tb["embeds"] = torch.from_numpy(
                np.asarray(emb).view(np.int16).copy()).view(torch.bfloat16)
        out.append((rb, tb))
    return out


def _state(cfg, params, compression=True):
    step, ocfg = tsteps.make_train_step(cfg, grad_compression=compression)
    return step, ocfg, params, opt_init(ocfg, params), \
        init_error_feedback(params)


def _clone(tree):
    return map_tree(lambda t: t.detach().clone(), tree)


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("name", FAMILIES)
def test_wrapper_step_matches_the_donated_jitted_step(smoke_model, name):
    rcfg, rparams = smoke_model(name)
    tcfg = smoke_config(ARCHS[name])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    rstep, rocfg = rsteps.make_train_step(rcfg, grad_compression=True)
    rstep = jax.jit(rstep, donate_argnums=(0, 1, 2))
    # donation consumes the arguments: hand it copies, not the cached draw
    rp = jax.tree.map(jnp.copy, rparams)
    rs, re = ropt_init(rocfg, rp), rerr(rp)
    tstep, tocfg, _, ts, te = _state(tcfg, tparams)
    run = ttrain.TrainGraph(tstep, tparams, ts, te)
    assert not run.captures
    lrs = 0.0
    for i, (rb, tb) in enumerate(_batches(tcfg)):
        rp, rs, re, rm = rstep(rp, rs, re, rb)
        tmet = run(tb)
        assert abs(float(tmet["loss"]) - float(rm["loss"])) <= 1e-2
        want_n = float(rm["grad_norm"])
        assert abs(float(tmet["grad_norm"]) - want_n) <= 0.03 * want_n
        assert float(tmet["lr"]) == float(rm["lr"])
        assert int(run.opt_state["step"]) == int(rs["step"]) == i + 1
        lrs += float(rm["lr"])
    assert run.graph is None and run.capture_s is None
    want = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    n_diff = n_all = 0
    for k, p in leaves_with_paths(run.params):
        a, b = p.detach().float().numpy(), want[k]
        n_diff, n_all = n_diff + int((a != b).sum()), n_all + a.size
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert ((np.abs(a - b) <= ulp) | (np.abs(a - b) <= 2 * lrs)).all(), k
    assert n_diff <= 0.01 * n_all


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "llava-next-34b"])
def test_state_is_written_in_place_and_equals_the_plain_step(name,
                                                             compression):
    """The wrapper's state tensors keep their storage across three steps
    (a donated buffer's), and every leaf, the step counter, the residuals
    and the metrics equal the plain step's on a copy, bit for bit."""
    cfg = smoke_config(ARCHS[name])
    params = tm.init_params(cfg, seed=0, device="cpu")
    step, _, _, state, err = _state(cfg, params, compression)
    plain = [_clone(params), _clone(state), _clone(err)]
    run = ttrain.TrainGraph(step, params, state, err)
    ptrs = {k: t.data_ptr() for k, t in leaves_with_paths(run.state)}
    for _, tb in _batches(cfg):
        got = {k: float(v) for k, v in run(tb).items()}
        *plain, pm = step(*plain, tb)
        assert got == {k: float(v) for k, v in pm.items()}
    assert {k: t.data_ptr() for k, t in leaves_with_paths(run.state)} \
        == ptrs
    assert run.params is params and run.opt_state is state and run.err is err
    want = dict(leaves_with_paths({"params": plain[0], "opt": plain[1],
                                   "err": plain[2]}))
    assert set(want) == set(ptrs)
    for k, t in leaves_with_paths(run.state):
        assert torch.equal(_bits(t), _bits(want[k])), k
    assert int(state["step"]) == STEPS


def test_a_batch_of_another_shape_raises():
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = tm.init_params(cfg, seed=0, device="cpu")
    step, _, _, state, err = _state(cfg, params)
    run = ttrain.TrainGraph(step, params, state, err)
    tb = _batches(cfg, n=1)[0][1]
    run(tb)
    before = _clone(run.state)
    short = {k: v[:, :SEQ // 2] for k, v in tb.items()}
    wide = {k: v.long() for k, v in tb.items()}
    for bad in (short, wide, {"tokens": tb["tokens"]}):
        with pytest.raises(ValueError, match="replays only"):
            run(bad)
    for (k, t), (_, u) in zip(leaves_with_paths(run.state),
                              leaves_with_paths(before)):
        assert torch.equal(_bits(t), _bits(u)), k


@pytest.mark.parametrize("name", ["qwen2-0.5b", "llava-next-34b"])
def test_train_on_the_cpu_is_the_plain_steps_loop(name):
    """``train()`` on the CPU runs the wrapper eagerly: its history and
    final state equal a loop of the plain ``make_train_step`` over the
    same stream (the frontend stub's embeds for llava), bit for bit."""
    out = ttrain.train(arch=name, steps=STEPS, smoke=True, seq_len=SEQ,
                       global_batch=BATCH, device="cpu", log_every=100)
    cfg = smoke_config(ARCHS[name])
    step, _, params, state, err = _state(
        cfg, tm.init_params(cfg, seed=0, device="cpu"))
    data = ShardedTokenStream(DataConfig(cfg.vocab, SEQ, BATCH))
    history = []
    for i in range(STEPS):
        toks = torch.from_numpy(np.ascontiguousarray(
            data.batch_at(i)["tokens"]))
        batch = {"labels": toks}
        if cfg.uses_tokens:
            batch["tokens"] = toks
        else:
            batch["embeds"] = ttrain.frontend_embeds(cfg, toks, 0, i)
        params, state, err, m = step(params, state, err, batch)
        history.append({k: float(v) for k, v in m.items()})
    assert [{k: h[k] for k in ("loss", "grad_norm", "lr")}
            for h in out["history"]] == history
    assert out["losses"] == [h["loss"] for h in history]
    assert out["capture_s"] is None and out["warmup_s"] is None
    want = dict(leaves_with_paths({"params": params, "opt": state,
                                   "err": err}))
    got = leaves_with_paths({"params": out["params"],
                             "opt": out["opt_state"], "err": out["err"]})
    assert [k for k, _ in got] == sorted(want)
    for k, t in got:
        assert torch.equal(_bits(t), _bits(want[k])), k


def test_remat_stashes_no_rng_state(monkeypatch):
    """Each remat layer goes through ``checkpoint`` with
    ``preserve_rng_state=False``: no layer draws a random number, and
    reading the card's generator state inside a capture raises."""
    calls = []
    checkpoint = tm.checkpoint

    def recording(fn, *args, **kw):
        calls.append(kw)
        return checkpoint(fn, *args, **kw)
    monkeypatch.setattr(tm, "checkpoint", recording)
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen2-0.5b"]), remat=True)
    params = tm.init_params(cfg, seed=0, device="cpu")
    tb = _batches(cfg, n=1)[0][1]
    tsteps.loss_and_grads(cfg, params, tb)
    assert len(calls) == cfg.n_layers
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False}
               for kw in calls)
