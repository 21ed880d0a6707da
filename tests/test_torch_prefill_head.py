"""The serving engine's prefill applies the final norm and the LM head at
the last position alone (``decode_step(..., last_only=True)``): the
(B, S, vocab) logits of the whole prompt are never made, since the
engine reads one row of them.

* the engine's prefill logits equal ``decode_step(...)[0][:, -1]`` of the
  full-width forward, for every family the engine serves.  The comparison
  is exact: the norm and the head are per position, and on the CPU the
  kept row's matmul gives the same bits as the full one's last row;
* the cache after the prefill, and the tokens served after it, are the
  same on the last-position path and on the full-logits one, with pages
  spilled through the tier;
* ``forward`` / ``decode_step`` keep (B, S, vocab) by default, for every
  arch, the frontends' ``embeds`` included, and ``last_only`` gives that
  tensor's last row;
* the ``engine.forward`` span carries the bytes of the logits it made:
  B x vocab x 2 at every prefill, whichever path enters the engine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    LOSSLESS_POLICY, MultiStreamEngine, ServeEngine, serving,
)

SERVED = sorted(n for n, c in ARCHS.items() if c.causal and c.uses_tokens)
B, PROMPT, NEW = 2, 40, 6
ENGINE = dict(max_seq=96, batch=B, page_tokens=16, device="cpu")
SPILL = 1 << 12             # bytes of HBM KV: the prompt's pages spill


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=SERVED)
def model(request):
    cfg = smoke_config(ARCHS[request.param])
    return cfg, tm.init_params(cfg, seed=4, device="cpu")


def _prompt(cfg, seed=0, batch=B, n=PROMPT):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, n), dtype=np.int32)


def _full_logits(monkeypatch):
    """Run the engine on the full-logits path: its step's forward makes
    every position's logits, as before the head moved to the last one."""
    def full(cfg, params, batch, cache, last_only=False):
        return tm.decode_step(cfg, params, batch, cache)
    monkeypatch.setattr(serving, "decode_step", full)


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


def _same_tree(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(_bits(a[k]), _bits(b[k])), k


def test_every_served_family_is_covered():
    assert SERVED == ["deepseek-v2-lite-16b", "falcon-mamba-7b",
                      "grok-1-314b", "nemotron-4-340b", "qwen1.5-32b",
                      "qwen2-0.5b", "stablelm-12b", "zamba2-7b"]
    assert {ARCHS[n].family for n in SERVED} == {"dense", "moe", "ssm",
                                                 "hybrid"}
    assert any(ARCHS[n].mla for n in SERVED)


def test_prefill_logits_are_the_full_forwards_last_row(model):
    """Nothing spills (a large budget), so the engine's cache is the
    forward's alone: both are compared bit for bit with the full-width
    ``decode_step`` on a cache of their own."""
    cfg, params = model
    prompt = _prompt(cfg)
    eng = ServeEngine(cfg, params, hbm_kv_budget=1 << 30, **ENGINE)
    got = eng.prefill(prompt)
    cache = tm.init_cache(cfg, B, ENGINE["max_seq"], device="cpu")
    full, _ = tm.decode_step(cfg, params, {
        "tokens": torch.from_numpy(prompt.astype(np.int64)),
        "cache_pos": 0}, cache)
    assert full.shape == (B, PROMPT, cfg.vocab)
    want = full[:, -1].float().numpy()
    assert got.shape == (B, cfg.vocab) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)       # exact: equal bits
    assert eng.stats().spilled_pages == 0
    _same_tree(eng.cache, cache)
    eng.retire()


def test_cache_and_tokens_same_on_both_paths(model, monkeypatch):
    """Pages spill through the tier at the prefill and come back during
    the decode: the last-position path and the full-logits one leave the
    same cache after the prefill (its readback applied), hand back the
    same logits and serve the same tokens."""
    cfg, params = model
    prompt = _prompt(cfg, seed=1)

    def run():
        eng = ServeEngine(cfg, params, hbm_kv_budget=SPILL,
                          policy=LOSSLESS_POLICY, **ENGINE)
        logits = eng.prefill(prompt)
        eng.flush_io()
        cache = serving._clone_tree(eng.cache)
        toks = []
        for _ in range(NEW):
            nxt = logits.argmax(-1).astype(np.int32)
            toks.append(nxt)
            logits = eng.decode(nxt.reshape(-1, 1))
        spilled = eng.stats().spilled_pages
        eng.retire()
        return cache, np.stack(toks, 1), spilled

    cache, toks, spilled = run()
    with monkeypatch.context() as m:
        _full_logits(m)
        cache_full, toks_full, spilled_full = run()
    _same_tree(cache, cache_full)
    np.testing.assert_array_equal(toks, toks_full)
    assert spilled == spilled_full
    if "layers" in cache and ("k" in cache["layers"]
                              or "c_kv" in cache["layers"]):
        assert spilled > 0                          # the tier did work


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_keeps_every_position_by_default(name):
    """Every arch, the frontends' ``embeds`` and the encoder included:
    ``forward`` gives (B, S, vocab) unless asked for the last position,
    which is that tensor's last row, bit for bit."""
    cfg = smoke_config(ARCHS[name])
    params = tm.init_params(cfg, seed=2, device="cpu")
    g = torch.Generator().manual_seed(3)
    if cfg.uses_tokens:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, PROMPT),
                                         generator=g)}
    else:
        batch = {"embeds": torch.randn(B, PROMPT, cfg.d_model, generator=g)}
    with torch.no_grad():
        full, _ = tm.forward(cfg, params, batch)
        last, _ = tm.forward(cfg, params, batch, last_only=True)
    assert full.shape == (B, PROMPT, cfg.vocab)
    assert last.shape == (B, 1, cfg.vocab) and last.dtype == full.dtype
    assert torch.equal(last, full[:, -1:])
    if cfg.causal:
        step, _ = tm.decode_step(cfg, params, dict(batch, cache_pos=0),
                                 tm.init_cache(cfg, B, 64, device="cpu"))
        assert step.shape == (B, PROMPT, cfg.vocab)


def test_forward_span_bytes_are_the_logits(model):
    """Recording open: each prefill's ``engine.forward`` carries
    B x vocab x 2 bytes (one bf16 row a sequence), and so does each eager
    decode step's on the CPU."""
    cfg, params = model
    eng = ServeEngine(cfg, params, hbm_kv_budget=SPILL, key_prefix="r0.",
                      **ENGINE)
    with spans.record() as rec:
        eng.generate(_prompt(cfg, seed=2), 3)
    eng.retire()
    names = [s.name for s in rec.spans]
    fwd = [s for s in rec.spans if s.name == "engine.forward"]
    under = [names[s.parent] for s in fwd]
    assert under == ["engine.prefill"] + ["engine.decode"] * 3
    assert [s.nbytes for s in fwd] == [B * cfg.vocab * 2] * 4


@pytest.mark.parametrize("path", ["streams", "scheduler"])
def test_every_path_into_the_prefill_takes_the_last_position(path):
    """``MultiStreamEngine`` and ``ServeScheduler`` prefill through
    ``ServeEngine.prefill``: each of their prefills' ``engine.forward``
    spans carries one row a sequence."""
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = tm.init_params(cfg, seed=5, device="cpu")
    kw = dict(page_tokens=16, hbm_kv_budget=SPILL, device="cpu")
    with spans.record() as rec:
        if path == "streams":
            MultiStreamEngine(cfg, params, 2, max_seq=64, batch=B,
                              **kw).generate(
                [_prompt(cfg, seed=i) for i in range(2)], 3)
            n, batch = 2, B
        else:
            reqs = [serving.ServeRequest(
                req_id=i, arrival=float(i), prompt=_prompt(cfg, i, 1, 24 + i),
                max_new_tokens=3) for i in range(3)]
            serving.ServeScheduler(cfg, params, max_batch=2,
                                   **kw).run(reqs)
            n, batch = 3, 1
    names = [s.name for s in rec.spans]
    fwd = [s for s in rec.spans if s.name == "engine.forward"
           and names[s.parent] == "engine.prefill"]
    assert len(fwd) == n
    assert all(s.nbytes == batch * cfg.vocab * 2 for s in fwd)
