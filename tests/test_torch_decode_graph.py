"""Port vs reference: the decode step with its position on the device.

The reference's engine runs every step through ``_jit_step =
jax.jit(decode_step, static_argnums=0)`` with ``cache_pos`` a traced
``jnp.int32``; the port's ``decode_step`` takes a 0-d int32 tensor on the
model's device the same way (nothing reads it on the host, so a card's
engine captures the step once in a CUDA graph and replays it).  On the
CPU there is no graph: the engine runs that step eagerly, and these tests
hold it to the reference, for every causal arch the engine serves, at
smoke width:

* the tensor-position step against the reference's ``_jit_step``, token
  by token from position 0 to the cache's last slot: atol 0.0625 and RMS
  0.01 (the bound ``tests/test_torch_arch.py`` holds the jitted step
  to), but zamba2-7b at atol 0.15 and RMS 0.03, the bound
  ``tests/test_torch_hybrid.py`` holds it to (the smoke hybrid amplifies
  a bf16 ulp past the token decoders' bound; see that file);
* the tensor-position step == the int-position step bit for bit, logits
  and every cache leaf, at every position (0, the 16-token page boundary
  and the last slot among them), a prompt written at a tensor position
  too;
* a position past the cache raises (the reference clamps it silently);
* ``decode_attention_plain`` (what the CPU runs for the kernel) with a
  tensor ``valid_len`` == with an int;
* a ``ServeEngine`` (``trace`` tier, qwen2-0.5b) against the reference
  engine as ``tests/test_torch_serving.py`` holds it: teacher-forced
  logits within the margin-aware bound of ``tests/test_kv_dtype.py``,
  the same spilled pages and logical bytes — its decode steps taking a
  tensor position.

The graph itself runs only on a card: ``tests/test_torch_kernels_gpu.py``
holds the replay to the eager step bit for bit there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_serving import ENGINE, _teacher_forced  # noqa: E402
from test_torch_ssm import _margin_bound, pairs  # noqa: E402

from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.runtime import ServeEngine as RServe  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro.runtime import serving as rserving  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import ServeEngine as TServe  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module
__all__ = ["pairs"]     # the fixture, shared with test_torch_ssm

ATOL, RMS = 0.0625, 0.01
HYBRID_ATOL, HYBRID_RMS = 0.15, 0.03
B, CAP, PROMPT = 2, 20, 5       # CAP slots: page boundary 16, last slot 19
SERVED = sorted(n for n, c in ARCHS.items() if c.causal and c.uses_tokens)
LINEAR = ["qwen2-0.5b", "deepseek-v2-lite-16b"]     # GQA and MLA caches


def test_served_archs_are_every_causal_token_model():
    assert SERVED == ["deepseek-v2-lite-16b", "falcon-mamba-7b",
                      "grok-1-314b", "nemotron-4-340b", "qwen1.5-32b",
                      "qwen2-0.5b", "stablelm-12b", "zamba2-7b"]
    for name in SERVED:
        tserving.check_servable(ARCHS[name])


def _tokens(cfg, n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)


def _port_run(cfg, params, toks, tensor: bool, prompt: int = 0):
    """The port's logits (B, T, vocab) f32 and the final cache: an
    optional prompt of ``prompt`` tokens at position 0, then one token a
    step; positions as 0-d int32 tensors (``tensor``) or ints."""
    cache = tm.init_cache(cfg, B, CAP, device="cpu")
    spans = ([(0, prompt)] if prompt else []) + [
        (t, t + 1) for t in range(prompt, toks.shape[1])]
    out = []
    for lo, hi in spans:
        pos = torch.tensor(lo, dtype=torch.int32) if tensor else lo
        logits, cache = tm.decode_step(cfg, params, {
            "tokens": torch.from_numpy(toks[:, lo:hi]), "cache_pos": pos},
            cache)
        out.append(logits)
    return torch.cat(out, dim=1).float().numpy(), cache


@pytest.fixture(scope="module")
def runs(pairs):
    """Per arch, token by token through all CAP slots: the reference's
    ``_jit_step`` at ``jnp.int32`` positions, the port at tensor and at
    int positions."""
    memo = {}

    def get(name):
        if name not in memo:
            rcfg, rparams, tcfg, tparams = pairs(name)
            toks = _tokens(tcfg, CAP)
            jc = jinit_cache(rcfg, B, CAP)
            ref = []
            for t in range(CAP):
                lj, jc = rserving._jit_step(rcfg, rparams, {
                    "tokens": jnp.asarray(toks[:, t:t + 1]),
                    "cache_pos": jnp.int32(t)}, jc)
                ref.append(np.asarray(lj, np.float32))
            memo[name] = (np.concatenate(ref, 1),
                          _port_run(tcfg, tparams, toks, True),
                          _port_run(tcfg, tparams, toks, False))
        return memo[name]
    return get


@pytest.mark.parametrize("name", SERVED)
def test_tensor_position_step_matches_reference_jit(runs, name):
    ref, (got, _), _ = runs(name)
    atol, rms = ((HYBRID_ATOL, HYBRID_RMS) if name == "zamba2-7b"
                 else (ATOL, RMS))
    assert np.isfinite(got).all()
    diff = np.abs(ref - got)
    assert diff.max() <= atol, diff.max()
    assert np.sqrt(np.mean(diff ** 2)) <= rms


def _leaves(tree):
    return [v for k in sorted(tree) for v in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("name", SERVED)
def test_tensor_position_equals_int_position(runs, name):
    """Every slot 0 .. CAP - 1 (the page boundary 16 and the last slot
    among them): logits and the whole cache bit-equal."""
    _, (got_t, cache_t), (got_i, cache_i) = runs(name)
    np.testing.assert_array_equal(got_t, got_i)
    for a, b in zip(_leaves(cache_t), _leaves(cache_i), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SERVED)
def test_prompt_at_tensor_position_equals_int_position(pairs, name):
    """A prompt written through the cache at a tensor position, then
    single tokens: bit-equal to the int positions."""
    _, _, cfg, params = pairs(name)
    toks = _tokens(cfg, 9, seed=3)
    got_t, cache_t = _port_run(cfg, params, toks, True, prompt=PROMPT)
    got_i, cache_i = _port_run(cfg, params, toks, False, prompt=PROMPT)
    np.testing.assert_array_equal(got_t, got_i)
    for a, b in zip(_leaves(cache_t), _leaves(cache_i), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", LINEAR)
def test_position_past_the_cache_raises(pairs, name):
    """A host position whose tokens pass the capacity raises ValueError
    before any write; a device position past it cannot be checked on the
    host (that would sync), and the CPU's indexed write refuses it (the
    engine checks its position first; the kernel clamps)."""
    _, _, cfg, params = pairs(name)
    cache = tm.init_cache(cfg, B, CAP, device="cpu")
    before = [t.clone() for t in _leaves(cache)]
    one = torch.zeros((B, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="does not fit"):
        tm.decode_step(cfg, params, {"tokens": one, "cache_pos": CAP}, cache)
    with pytest.raises(ValueError, match="does not fit"):
        tm.decode_step(cfg, params, {"tokens": torch.zeros(
            (B, 2), dtype=torch.int64), "cache_pos": CAP - 1}, cache)
    for a, b in zip(_leaves(cache), before, strict=True):
        assert torch.equal(a, b)
    with pytest.raises(IndexError):
        tm.decode_step(cfg, params, {"tokens": one, "cache_pos": torch.tensor(
            CAP, dtype=torch.int32)}, cache)
    tm.decode_step(cfg, params, {"tokens": one, "cache_pos": CAP - 1}, cache)


def test_engine_raises_past_max_seq(pairs):
    _, _, cfg, params = pairs("qwen2-0.5b")
    eng = TServe(cfg, params, max_seq=PROMPT + 2, page_tokens=16,
                 device="cpu")
    prompt = _tokens(cfg, PROMPT)[:1]
    eng.prefill(prompt)
    eng.decode(prompt[:, :1])
    eng.decode(prompt[:, :1])
    with pytest.raises(ValueError, match="max_seq"):
        eng.decode(prompt[:, :1])
    assert eng.pos == PROMPT + 2


def test_a_float_or_batched_position_is_refused(pairs):
    _, _, cfg, params = pairs("qwen2-0.5b")
    cache = tm.init_cache(cfg, B, CAP, device="cpu")
    one = torch.zeros((B, 1), dtype=torch.int64)
    for pos in (torch.tensor(1.0), torch.tensor([1, 1], dtype=torch.int32)):
        with pytest.raises(TypeError, match="0-d integer"):
            tm.decode_step(cfg, params, {"tokens": one, "cache_pos": pos},
                           cache)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
def test_plain_attention_tensor_length_equals_int(kv):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 14, 64),
                                             dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal(
        (2, 96, 2, 64), dtype=np.float32)).to(kv) for _ in range(2))
    for valid in (1, 31, 32, 33, 64, 95, 96):
        want = decode_attn.decode_attention_plain(q, k, v, valid)
        length = torch.tensor(valid, dtype=torch.int32)
        assert torch.equal(decode_attn.decode_attention_plain(
            q, k, v, length), want)
        assert torch.equal(decode_attn.decode_attention(q, k, v, length),
                           want)
    # a device length is clamped to [1, S], as the kernel clamps it
    for length, valid in ((0, 1), (-3, 1), (97, 96), (1000, 96)):
        assert torch.equal(decode_attn.decode_attention_plain(
            q, k, v, torch.tensor(length, dtype=torch.int32)),
            decode_attn.decode_attention_plain(q, k, v, valid))
    with pytest.raises(TypeError, match="0-d integer"):
        decode_attn.decode_attention(q, k, v, torch.tensor(3.0))
    before = dict(build.LAUNCHES)
    decode_attn.decode_attention(q, k, v, torch.tensor(5))
    assert build.LAUNCHES == before         # a CPU tensor launches nothing


def test_engine_with_tensor_positions_tracks_reference_engine(
        pairs, monkeypatch):
    """qwen2-0.5b, as ``tests/test_torch_serving.py`` holds it (its own
    engine tests, and ``tests/test_torch_mla_serving.py``'s for the MLA
    engine with its router near-ties set apart, run the same tensor
    positions now)."""
    rcfg, rparams, tcfg, tparams = pairs("qwen2-0.5b")
    seen = []
    step = tserving.decode_step

    def recording(cfg, params, batch, cache):
        pos = batch["cache_pos"]
        seen.append((batch["tokens"].shape[1], type(pos), getattr(
            pos, "dtype", None)))
        return step(cfg, params, batch, cache)

    monkeypatch.setattr(tserving, "decode_step", recording)
    teng = TServe(tcfg, tparams, policy=tpaging.PAPER_POLICY, device="cpu",
                  **ENGINE)
    reng = RServe(rcfg, rparams, policy=rpaging.PAPER_POLICY, **ENGINE)
    toks = (np.arange(60, dtype=np.int32).reshape(1, 60) * 7) % tcfg.vocab
    got = _teacher_forced(teng, toks, 48)
    ref = _teacher_forced(reng, toks, 48)
    # prefill at a host int; each decode step at a 0-d int32 tensor
    assert seen[0] == (48, int, None)
    assert seen[1:] == [(1, torch.Tensor, torch.int32)] * 12
    ts, rs = teng.stats(), reng.stats()
    assert ts.spilled_pages == rs.spilled_pages > 0
    assert ts.kv_logical_bytes == rs.kv_logical_bytes
    _margin_bound(ref, got)
    assert teng.graph is None               # no graph on the CPU


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-7b"])
def test_recurrent_engine_decodes_at_tensor_positions(pairs, name):
    """The recurrent models serve with nothing paged; the engine's
    tokens equal a greedy run of the port's int-position steps."""
    _, _, cfg, params = pairs(name)
    prompt = _tokens(cfg, 24)[:1]
    eng = TServe(cfg, params, max_seq=40, page_tokens=16, device="cpu")
    got = eng.generate(prompt, 6)
    cache = tm.init_cache(cfg, 1, 40, device="cpu")
    logits, _ = tm.decode_step(cfg, params, {
        "tokens": torch.from_numpy(prompt), "cache_pos": 0}, cache)
    want = []
    for t in range(6):
        nxt = logits[:, -1].float().argmax(-1)
        want.append(int(nxt))
        logits, _ = tm.decode_step(cfg, params, {
            "tokens": nxt[:, None], "cache_pos": 24 + t}, cache)
    assert got.tolist() == [want]
    assert eng.stats().spilled_pages == 0


def test_cache_capacity():
    """The slots a host position is checked against: a linear KV cache's
    (GQA ``k``, MLA ``c_kv``); none for the Mamba states or the hybrid's
    rolling window, which take any position."""
    for name in LINEAR:
        cache = tm.init_cache(smoke_config(ARCHS[name]), 1, CAP,
                              device="cpu")
        assert tm.cache_capacity(cache) == CAP
    for name in ("falcon-mamba-7b", "zamba2-7b"):
        cache = tm.init_cache(smoke_config(ARCHS[name]), 1, CAP,
                              device="cpu")
        assert tm.cache_capacity(cache) is None
