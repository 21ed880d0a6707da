"""Port vs reference: the Mamba2 hybrid (zamba2-7b) at ``smoke_config``
with the reference's weights (``params_from_jax``) — the Mamba2 mixer,
the shared attention block over its rolling-window cache, and the
model's prefill, decode and forward.

Tolerances:
* ``mamba2_mix`` against the reference run op by op under
  ``jax.disable_jit()``: the output within 2 bf16 ulps of its largest
  value, the f32 scan state within f32 tolerance (rtol 1e-5, atol 1e-6)
  and the conv state bit-equal; against the jitted reference: atol
  0.0625 and RMS 0.01 (``tests/test_torch_model.py``);
* the shared attention block over a rolling cache against the jitted
  reference's, one token: its output within 2 bf16 ulps of its largest
  value, the written K / V slot and ``kpos`` equal;
* model logits against the reference: atol 0.15 and RMS 0.03, greedy
  tokens within the margin-aware bound of ``tests/test_kv_dtype.py``.
  The smoke hybrid amplifies a bf16 ulp: the reference's own jitted and
  op-by-op forwards differ by 0.10 (RMS 0.018) on an 80-token input,
  and one ulp on one embedding element moves the port's logits by 0.08
  (RMS 0.010), so the model bound of the token decoders (atol 0.0625,
  RMS 0.01) is below what either package holds itself to; 0.15 is the
  reference's own decode == forward bound;
* decode == forward within the port: rtol = atol = 0.15
  (``tests/test_arch_smoke.py``).

The reference records only the first written slot's position when a
prompt of S > 1 tokens goes through the cache (``layers.py:176–180``,
``model.py:484–488``), so its prefill attends to one prompt token and
differs from its forward; a prompt longer than the window raises.  The
port records every slot's position and writes a long prompt as a
rolling window; ``test_reference_prefill_fault_is_not_copied`` shows
both.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_ssm import (  # noqa: E402
    B, _margin_bound, _tokens, _ulps, bf16, check_mix, pairs,
    port_trajectory,
)

from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

__all__ = ["pairs"]     # the fixture, shared with test_torch_ssm


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

NAME = "zamba2-7b"
ZATOL, ZRMS = 0.15, 0.03
T, MAX_SEQ = 80, 96             # past the smoke window of 64


def _hybrid_bound(ref, got):
    assert np.isfinite(got).all()
    diff = np.abs(ref - got)
    assert diff.max() <= ZATOL, diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= ZRMS
    _margin_bound(ref, got)


def _ref_forward(rcfg, rparams, toks):
    out, _, _ = jax.jit(lambda p, b: jforward(rcfg, p, b))(
        rparams, {"tokens": jnp.asarray(toks)})
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 16, 40])
def test_mamba2_mix_matches_reference(pairs, S, with_state):
    check_mix(pairs(NAME), "mamba2_mix", S, with_state)


@pytest.mark.parametrize("cache_pos", [40, 70])
def test_rolling_attention_step_matches_reference(pairs, cache_pos):
    """One token over a rolling cache holding positions < cache_pos at
    slot ``p % W`` (stale slots at -2 * window): the output, the written
    slot and its position equal the reference's, whose single-token path
    records the position."""
    rcfg, rparams, tcfg, tparams = pairs(NAME)
    W, w = 64, tcfg.window
    rng = np.random.default_rng(cache_pos)
    shape = (B, W, tcfg.n_kv_heads, tcfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    kpos = np.full((B, W), -2 * w, np.int32)
    for p in range(cache_pos):
        kpos[:, p % W] = p
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), cache_pos, np.int32)
    jc = {"k": jnp.asarray(k0, jnp.bfloat16), "v": jnp.asarray(v0, jnp.bfloat16),
          "kpos": jnp.asarray(kpos)}
    want, new = jax.jit(lambda x, p, c: rlayers.gqa_block(
        x, p, rcfg, positions=jnp.asarray(pos), cache=c,
        cache_pos=cache_pos % w, window=w))(
            jnp.asarray(x, jnp.bfloat16), rparams["shared"]["attn"], jc)
    tc = {"k": bf16(k0), "v": bf16(v0), "kpos": torch.from_numpy(kpos.copy())}
    got = tlayers.gqa_block(bf16(x), tparams["shared"]["attn"], tcfg,
                            positions=torch.from_numpy(pos), cache=tc,
                            window=w)
    _ulps(np.asarray(want, np.float32), got.float().numpy(), 2)
    for kind in ("k", "v"):
        np.testing.assert_array_equal(tc[kind].float().numpy(),
                                      np.asarray(new[kind], np.float32))
    want_pos = kpos.copy()
    want_pos[:, cache_pos % W] = cache_pos
    np.testing.assert_array_equal(tc["kpos"].numpy(), want_pos)


@pytest.mark.parametrize("S", [40, 80])
def test_prefill_into_cache_matches_reference_forward(pairs, S):
    """The port's prefill of an S-token prompt through the cache (80:
    longer than the 64-slot window, written as a rolling window) against
    the reference's forward, then 12 teacher-forced steps against the
    reference's forward over the whole sequence; every written slot holds
    its position."""
    rcfg, rparams, tcfg, tparams = pairs(NAME)
    toks = _tokens(tcfg, S + 12, seed=S)
    want = _ref_forward(rcfg, rparams, toks)
    spans = [(0, S)] + [(S + t, S + t + 1) for t in range(12)]
    cache = tm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    pre, cache = tm.decode_step(tcfg, tparams, {
        "tokens": torch.from_numpy(toks[:, :S]), "cache_pos": 0}, cache)
    _hybrid_bound(want[:, :S], pre.float().numpy())
    W = cache["attn_pos"].shape[-1]
    kpos = np.full(W, -2 * tcfg.window, np.int32)
    for p in range(S):
        kpos[p % W] = p
    np.testing.assert_array_equal(cache["attn_pos"][0, 0].numpy(), kpos)
    got = port_trajectory(tcfg, tparams, toks, spans, MAX_SEQ)
    _hybrid_bound(want[:, [hi - 1 for _, hi in spans]], got)


def test_tokenwise_decode_matches_reference(pairs):
    """Both packages decode the same 80 tokens one at a time, past the
    window, so the rolling cache wraps."""
    rcfg, rparams, tcfg, tparams = pairs(NAME)
    toks = _tokens(tcfg, T, seed=1)
    step = jax.jit(jdecode, static_argnums=0)
    jc = jinit_cache(rcfg, B, MAX_SEQ)
    ref = []
    for t in range(T):
        lj, jc = step(rcfg, rparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                      "cache_pos": jnp.int32(t)}, jc)
        ref.append(np.asarray(lj[:, 0], np.float32))
    spans = [(t, t + 1) for t in range(T)]
    got = port_trajectory(tcfg, tparams, toks, spans, MAX_SEQ)
    _hybrid_bound(np.stack(ref, 1), got)


def test_decode_matches_forward(pairs):
    _, _, cfg, params = pairs(NAME)
    toks = _tokens(cfg, T, seed=3)
    full, _ = tm.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    full = full.float().numpy()
    steps = port_trajectory(cfg, params, toks, [(t, t + 1) for t in range(T)],
                            MAX_SEQ)
    np.testing.assert_allclose(steps, full, rtol=0.15, atol=0.15)
    spans = [(0, 70)] + [(t, t + 1) for t in range(70, T)]
    mixed = port_trajectory(cfg, params, toks, spans, MAX_SEQ)
    np.testing.assert_allclose(mixed, full[:, [hi - 1 for _, hi in spans]],
                               rtol=0.15, atol=0.15)


def test_reference_prefill_fault_is_not_copied(pairs):
    """The reference's prefill through the cache records one position, so
    it differs from its own forward and a prompt past the window raises;
    the port's equals its forward and keeps every position."""
    rcfg, rparams, tcfg, tparams = pairs(NAME)
    toks = _tokens(tcfg, 16, seed=2)
    fwd = _ref_forward(rcfg, rparams, toks)
    step = jax.jit(jdecode, static_argnums=0)
    jc = jinit_cache(rcfg, B, MAX_SEQ)
    pre, jc = step(rcfg, rparams, {"tokens": jnp.asarray(toks),
                                   "cache_pos": jnp.int32(0)}, jc)
    assert np.abs(np.asarray(pre, np.float32) - fwd).max() > 1.0
    np.testing.assert_array_equal(np.asarray(jc["attn_pos"])[0, 0, :16],
                                  [0] + [-2 * rcfg.window] * 15)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        step(rcfg, rparams, {"tokens": jnp.asarray(_tokens(tcfg, T)),
                             "cache_pos": jnp.int32(0)},
             jinit_cache(rcfg, B, MAX_SEQ))
    cache = tm.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    got, cache = tm.decode_step(tcfg, tparams, {
        "tokens": torch.from_numpy(toks), "cache_pos": 0}, cache)
    mine, _ = tm.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(got, mine)
    _hybrid_bound(fwd, got.float().numpy())
    np.testing.assert_array_equal(cache["attn_pos"][0, 0, :16].numpy(),
                                  np.arange(16))


def test_shared_block_applications(pairs, monkeypatch):
    """zamba2 applies its shared block after layers 0, 6, …, 72 (13 of
    81), each over its own cache slot; a 12-layer smoke hybrid applies it
    twice a step and writes both slots."""
    full = tm.shared_applications(ARCHS[NAME])
    assert full == [(6 * a, a) for a in range(13)]
    assert tm.cache_spec(ARCHS[NAME], 1, 576)["attn_k"].shape == \
        (13, 1, 576, 32, 112)
    _, _, cfg, params = pairs(NAME)
    cfg12 = dataclasses.replace(cfg, n_layers=12)
    p12 = tm.init_params(cfg12, seed=1, device="cpu")
    calls = []
    block = tlayers.gqa_block

    def counted(x, p, cfg, **kw):
        calls.append(kw["cache"]["kpos"].data_ptr())
        return block(x, p, cfg, **kw)
    monkeypatch.setattr(tlayers, "gqa_block", counted)
    cache = tm.init_cache(cfg12, 1, 32, device="cpu")
    for t in range(3):
        tm.decode_step(cfg12, p12, {"tokens": torch.tensor([[t + 1]]),
                                    "cache_pos": t}, cache)
    assert len(calls) == 6 and len(set(calls)) == 2
    np.testing.assert_array_equal(cache["attn_pos"][:, 0, :4].numpy(),
                                  [[0, 1, 2, -128]] * 2)


def test_hybrid_cache_layout():
    cfg = smoke_config(ARCHS[NAME])
    for max_seq, W in ((48, 48), (96, 64)):
        c = tm.init_cache(cfg, 2, max_seq, device="cpu")
        assert c["attn_k"].shape == c["attn_v"].shape == (1, 2, W, 4, 32)
        assert c["attn_pos"].dtype == torch.int32
        assert bool((c["attn_pos"] == -128).all())
        assert c["layers"]["conv"].dtype == torch.bfloat16
        assert c["layers"]["ssm"].dtype == torch.float32
        assert c["layers"]["ssm"].shape == (6, 2, 4, 64, 16)
    c8 = tm.init_cache(dataclasses.replace(cfg, kv_dtype="float8_e4m3fn"),
                       1, 48, device="cpu")
    assert c8["attn_k"].dtype == c8["layers"]["conv"].dtype == \
        torch.float8_e4m3fn
    assert c8["layers"]["ssm"].dtype == torch.float32
