"""Port vs reference: the train step and the train loop.

* a whole ``train_step`` (with and without gradient compression) against
  the reference's jitted ``make_train_step`` over the same three batches
  of the stream, labels aligned with the positions, from the same
  params: every step's loss within 1e-2 (bf16 forwards), ``grad_norm``
  within 3 % relative (the gradients are bf16 noise apart, see
  ``tests/test_torch_train.py``), the optimizer's step and lr equal;
  the bf16 params after three steps bit-equal on at least 99 % of all
  elements, and every element within one bf16 ulp of itself or ``2 *
  (the three steps' lr)`` of the reference's (AdamW's first steps move an
  element by about lr, under half an ulp of most weights; the
  zero-initialised norm scales and biases, whose ulps are that small,
  take the gradients' noise);
* the reference loop's fault: it passes the stream's ``labels``
  (``arr[:, 1:]``) to ``lm_loss``, which shifts again, so the logit at
  position t is scored against ``arr[:, t + 2]``; the port's loop passes
  the tokens as labels and scores it against ``arr[:, t + 1]``;
* the CLI with ``--smoke --cpu`` (and its restart), the ``train_100m``
  twin with ``--cpu`` at a few steps, the frontend stub's seeded embeds,
  and the card as the default device.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import ShardedTokenStream as RStream  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.launch.train import train as rtrain  # noqa: E402
from repro.models import forward as rforward  # noqa: E402
from repro.models.model import init_params as rinit_params  # noqa: E402
from repro.optim.grad_compress import init_error_feedback as rerr  # noqa: E402
from repro.optim import init as ropt_init  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.data import DataConfig, ShardedTokenStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import init as opt_init  # noqa: E402
from repro_torch.optim.grad_compress import init_error_feedback  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

SEQ, BATCH = 32, 2


def _bf16(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _to_torch(a):
    a = np.asarray(a)
    return _bf16(a) if a.dtype == jnp.bfloat16 else torch.from_numpy(a.copy())


def _ce(logits: np.ndarray, targets: np.ndarray) -> float:
    """Mean cross-entropy of f32 logits (B, T, V) against (B, T)."""
    z = logits - logits.max(-1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    return float(-np.take_along_axis(lp, targets[..., None], -1).mean())


@pytest.mark.parametrize("compression", [False, True])
def test_train_step_matches_reference(smoke_model, compression):
    name = "qwen2-0.5b"
    rcfg, rparams = smoke_model(name)
    tcfg = smoke_config(ARCHS[name])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    rstep, rocfg = rsteps.make_train_step(rcfg,
                                          grad_compression=compression)
    tstep, tocfg = tsteps.make_train_step(tcfg,
                                          grad_compression=compression)
    assert tocfg.lr == rocfg.lr and tocfg.moment_dtype == torch.float32
    rstep = jax.jit(rstep)
    rs, re = ropt_init(rocfg, rparams), rerr(rparams)
    ts, te = opt_init(tocfg, tparams), init_error_feedback(tparams)
    stream = ShardedTokenStream(DataConfig(tcfg.vocab, SEQ, BATCH))
    rp, tp, lrs = rparams, tparams, 0.0
    for step in range(3):
        toks = stream.batch_at(step)["tokens"]
        rp, rs, re, rm = rstep(rp, rs, re, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(toks)})
        t = torch.from_numpy(toks)
        tp, ts, te, tmet = tstep(tp, ts, te, {"tokens": t, "labels": t})
        assert abs(float(tmet["loss"]) - float(rm["loss"])) <= 1e-2
        want_n = float(rm["grad_norm"])
        assert abs(float(tmet["grad_norm"]) - want_n) <= 0.03 * want_n
        assert float(tmet["lr"]) == float(rm["lr"])
        assert int(ts["step"]) == int(rs["step"]) == step + 1
        lrs += float(rm["lr"])
    want = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(rp)[0]}
    n_diff = n_all = 0
    for k, p in leaves_with_paths(tp):
        a, b = p.detach().float().numpy(), want[k]
        n_diff, n_all = n_diff + int((a != b).sum()), n_all + a.size
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert ((np.abs(a - b) <= ulp) | (np.abs(a - b) <= 2 * lrs)).all(), k
    assert n_diff <= 0.01 * n_all


def _stream_rows(seed=0, step=0):
    """The stream's full rows ``arr`` (B, SEQ + 1) at ``step``."""
    b = RStream(RDataConfig(512, SEQ, BATCH, seed=seed)).batch_at(step)
    return np.concatenate([b["tokens"], b["labels"][:, -1:]], 1)


def test_reference_loop_trains_two_tokens_ahead(monkeypatch):
    """What the reference's ``train`` hands ``lm_loss`` at step 0 (read
    inside its jitted step): ``tokens = arr[:, :-1]``, ``labels =
    arr[:, 1:]``; ``lm_loss`` then scores ``logits[:, :-1]`` against
    ``labels[:, 1:]``, i.e. position t against ``arr[:, t + 2]`` — its
    step-0 loss is that cross-entropy, and not the next token's."""
    seen = {}
    lm_loss = rsteps.lm_loss

    def recording(cfg, params, batch):
        jax.debug.callback(lambda t, l: seen.setdefault("b", (
            np.asarray(t), np.asarray(l))), batch["tokens"], batch["labels"])
        return lm_loss(cfg, params, batch)
    monkeypatch.setattr(rsteps, "lm_loss", recording)
    out = rtrain(arch="qwen2-0.5b", steps=1, smoke=True, seq_len=SEQ,
                 global_batch=BATCH, ckpt_dir=None, log_every=100)
    arr = _stream_rows()
    tokens, labels = seen["b"]
    assert np.array_equal(tokens, arr[:, :-1])
    assert np.array_equal(labels, arr[:, 1:])
    cfg = rsmoke(RARCHS["qwen2-0.5b"])
    logits, _, _ = jax.jit(lambda p, t: rforward(cfg, p, {"tokens": t}))(
        rinit_params(cfg, jax.random.PRNGKey(0)), jnp.asarray(tokens))
    logits = np.asarray(logits, np.float32)[:, :-1]
    two_ahead, next_tok = _ce(logits, arr[:, 2:]), _ce(logits, arr[:, 1:-1])
    assert abs(out["losses"][0] - two_ahead) <= 1e-4
    assert abs(out["losses"][0] - next_tok) > 1e-3


def test_port_loop_trains_on_the_next_token(monkeypatch):
    """The port's loop passes the stream's tokens as the labels, so the
    logit at position t is scored against ``arr[:, t + 1]``."""
    seen = []
    lm_loss = tsteps.lm_loss

    def recording(cfg, params, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return lm_loss(cfg, params, batch)
    monkeypatch.setattr(tsteps, "lm_loss", recording)
    out = ttrain.train(arch="qwen2-0.5b", steps=1, smoke=True, seq_len=SEQ,
                       global_batch=BATCH, device="cpu", log_every=100)
    arr = _stream_rows()
    (batch,) = seen
    assert np.array_equal(batch["tokens"].numpy(), arr[:, :-1])
    assert torch.equal(batch["labels"], batch["tokens"])
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    with torch.no_grad():
        logits, _ = tm.forward(cfg, tm.init_params(cfg, seed=0,
                                                   device="cpu"),
                               {"tokens": batch["tokens"]})
    logits = logits.float().numpy()[:, :-1]
    assert abs(out["losses"][0] - _ce(logits, arr[:, 1:-1])) <= 1e-4
    assert abs(out["losses"][0] - _ce(logits, arr[:, 2:])) > 1e-3


def test_cli_smoke_cpu_and_restart(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ck")
    argv = ["train", "--smoke", "--cpu", "--seq-len", "32",
            "--global-batch", "2", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    for steps in ("2", "3"):
        monkeypatch.setattr(sys, "argv", argv + ["--steps", steps])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ttrain.main()
        text = buf.getvalue()
        assert "[train] done; final loss" in text
    assert "[train] restored step 2" in text and "step 2 loss" in text


def test_train_100m_twin_cpu():
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.examples import train_100m

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_100m.main(["--cpu", "--steps", "2"])
    assert "loss: start" in buf.getvalue() and len(out["losses"]) == 2
    cfg = PORT_ARCHS["qwen2-100m"]
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (6, 512, 32000)
    assert all(np.isfinite(out["losses"]))


def test_frontend_stub_embeds_are_seeded():
    cfg = smoke_config(ARCHS["llava-next-34b"])
    toks = torch.from_numpy(_stream_rows()[:, :-1])
    a = ttrain.frontend_embeds(cfg, toks, seed=0, step=3)
    assert a.shape == (BATCH, SEQ, cfg.d_model) and a.dtype == torch.bfloat16
    assert torch.equal(a, ttrain.frontend_embeds(cfg, toks, seed=0, step=3))
    assert not torch.equal(a, ttrain.frontend_embeds(cfg, toks, seed=0,
                                                     step=4))
    assert not torch.equal(a, ttrain.frontend_embeds(cfg, toks, seed=1,
                                                     step=3))
    out = ttrain.train(arch="llava-next-34b", steps=2, smoke=True,
                       seq_len=SEQ, global_batch=BATCH, device="cpu",
                       log_every=100)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


def test_train_runs_on_the_card_by_default():
    """No fallback hides a missing card: ``train`` without a device
    raises here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(steps=1, smoke=True, seq_len=SEQ, global_batch=BATCH)
