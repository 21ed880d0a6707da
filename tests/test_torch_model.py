"""Port vs reference: the dense GQA decoder with the reference's weights
(``params_from_jax``) — prefill and decode logits, bf16 and fp8 caches.

Tolerance: logits agree to atol 0.0625 (a few bf16 ulps at their
magnitude) with RMS below 0.01, because bf16 rounds at other places in
the two frameworks' fused ops.  Teacher-forced greedy tokens are held to
the margin-aware bound of ``tests/test_kv_dtype.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

ATOL, RMS = 0.0625, 0.01
B, PROMPT, STEPS, MAX_SEQ = 2, 40, 12, 64


@pytest.fixture(scope="module")
def pair(smoke_model):
    rcfg, rparams = smoke_model("qwen2-0.5b")
    tcfg = smoke_config(ARCHS["qwen2-0.5b"])
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, tcfg, tm.params_from_jax(tcfg, tree, device="cpu")


def _trajectories(pair, kv_dtype):
    """Teacher-forced logits (B, 1 + STEPS, vocab) from both packages: a
    prompt prefill, then STEPS single-token decode steps fed the same
    tokens."""
    rcfg, rparams, tcfg, tparams = pair
    rcfg = dataclasses.replace(rcfg, kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tcfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    step = jax.jit(jdecode, static_argnums=0)
    jc = jinit_cache(rcfg, B, MAX_SEQ)
    tc = tm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    assert tc["layers"]["k"].dtype == tm.KV_DTYPES[kv_dtype]
    js, ts = [], []
    spans = [(0, PROMPT)] + [(PROMPT + t, PROMPT + t + 1) for t in range(STEPS)]
    for lo, hi in spans:
        lj, jc = step(rcfg, rparams, {"tokens": jnp.asarray(toks[:, lo:hi]),
                                      "cache_pos": jnp.int32(lo)}, jc)
        lt, tc = tm.decode_step(tcfg, tparams, {
            "tokens": torch.from_numpy(toks[:, lo:hi]), "cache_pos": lo}, tc)
        js.append(np.asarray(lj[:, -1], np.float32))
        ts.append(lt[:, -1].float().numpy())
    return np.stack(js, 1), np.stack(ts, 1)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
def test_prefill_and_decode_logits_match_reference(pair, kv_dtype):
    ref, got = _trajectories(pair, kv_dtype)
    assert np.isfinite(got).all()
    diff = np.abs(ref - got)
    assert diff.max() <= ATOL, diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= RMS

    # greedy tokens: the margin-aware bound (flips only among near-ties)
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    assert rms < 0.5 * float(np.median(margin))
    assert agree[margin > 4.0 * rms].all()
    assert agree.mean() > 0.8
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99


def test_params_from_jax_is_bit_exact_and_checked(pair):
    rcfg, rparams, tcfg, tparams = pair
    wq = np.asarray(rparams["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(
        tparams["layers"]["attn"]["wq"].view(torch.int16).numpy(),
        wq.view(np.int16))
    tree = jax.tree.map(np.asarray, rparams)
    tree["layers"]["mlp"]["w1"] = tree["layers"]["mlp"]["w1"][:, :, :-1]
    with pytest.raises(ValueError, match="w1"):
        tm.params_from_jax(tcfg, tree, device="cpu")


def test_seeded_init_matches_schema_and_repeats():
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    a = tm.init_params(cfg, seed=5, device="cpu")
    b = tm.init_params(cfg, seed=5, device="cpu")
    schema = tm.schema(cfg)
    assert a["layers"]["attn"]["wq"].shape == schema["layers"]["attn"]["wq"][0]
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert not bool(a["layers"]["attn"]["bq"].any())      # biases start at 0
    std = float(a["layers"]["mlp"]["w2"].float().std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
