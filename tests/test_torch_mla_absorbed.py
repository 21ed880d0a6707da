"""MLA's decode step with absorbed weights (``layers._absorbed_attention``)
against an f64 evaluation of the re-expanded mathematics on the same
inputs: its largest error is no greater than 1.1 times that of the
re-expanded path (``layers._expanded_attention``, which the prompt keeps)
on every fixed seed, at DeepSeek-V2-Lite's attention widths (16 heads)
and at DeepSeek-V3's (128 heads, query LoRA, YaRN), over bf16 and
float8 latent caches, at the cache's first, middle and last slot; and
the cache it writes is bit for bit the re-expanded path's.  A prompt
whose length the query chunk does not divide attends in chunks too.

The model width is cut to 256 (the attention's own widths are the
published ones, ``tests/mla_cases.py``); the cache holds 24 slots.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from mla_cases import ATTN, cut, reexpanded  # noqa: E402

B, SMAX, D = 2, 24, 256
SEEDS = (0, 1, 2)
DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def _attn_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    tree = tm._map(tm._mla_specs(cfg, 1), lambda path, spec: tm._init_leaf(
        spec.shape, spec.init, gen, torch.device("cpu")))
    return tm._layer(tree, 0)


def _inputs(cfg, seed, dtype):
    gen = torch.Generator().manual_seed(1000 + seed)
    x = torch.randn(B, 1, D, generator=gen).to(torch.bfloat16)
    cache = {"c_kv": torch.randn(B, SMAX, cfg.kv_lora_rank, generator=gen),
             "k_rope": torch.randn(B, SMAX, 1, cfg.qk_rope_dim,
                                   generator=gen) * 0.5}
    return x, {k: v.to(dtype) for k, v in cache.items()}


def _f64_heads(q_nope, q_rope, c_kv, k_rope, p, scale, valid):
    """The re-expanded attention in f64 from the same bf16 / float8
    values: K = c_kv @ w_uk beside k_rope, V = c_kv @ w_uv."""
    Bq, H, hd = q_nope.shape
    c = c_kv.double()
    Sk = c.shape[1]
    k = (c @ p["w_uk"].double()).reshape(Bq, Sk, H, hd)
    v = (c @ p["w_uv"].double()).reshape(Bq, Sk, H, -1)
    s = (torch.einsum("bhd,bshd->bhs", q_nope.double() * scale, k)
         + torch.einsum("bhd,bsd->bhs", q_rope.double() * scale,
                        k_rope[:, :, 0].double()))
    s = torch.where(torch.arange(Sk) < valid, s,
                    torch.tensor(float("-inf"), dtype=torch.float64))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), v)


def _decode(cfg, p, x, cache, pos, monkeypatch):
    """``mla_block`` at one query position through a device-tensor
    position, as the engine's decode step runs it: its output and the
    absorbed attention's arguments."""
    seen = []
    real = L._absorbed_attention

    def spy(*args):
        seen.append(args)
        return real(*args)
    monkeypatch.setattr(L, "_absorbed_attention", spy)
    positions = torch.full((B, 1), pos, dtype=torch.int32)
    before = list(L.MLA_PATHS)
    out = L.mla_block(x, p, cfg, positions=positions, cache=cache,
                      cache_pos=torch.tensor(pos, dtype=torch.int32))
    monkeypatch.setattr(L, "_absorbed_attention", real)
    assert [n - b for n, b in zip(L.MLA_PATHS, before)] == [1, 0]
    assert len(seen) == 1
    return out, seen[0]


@pytest.fixture(scope="module", params=sorted(ATTN))
def model(request):
    cfg = cut(ATTN[request.param], D)
    return cfg, {s: _attn_params(cfg, s) for s in SEEDS}


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("kv", list(DTYPES))
def test_absorbed_decode_is_no_less_precise(model, kv, where, monkeypatch):
    cfg, params = model
    pos = {"first": 0, "middle": SMAX // 2, "last": SMAX - 1}[where]
    H, vh = cfg.n_heads, cfg.v_head_dim
    for seed in SEEDS:
        p = params[seed]
        x, cache = _inputs(cfg, seed, DTYPES[kv])
        out, args = _decode(cfg, p, x, cache, pos, monkeypatch)
        heads = L._absorbed_attention(*args)
        exp = reexpanded(*args)
        want = _f64_heads(*args)
        assert heads.dtype == exp.dtype == torch.bfloat16
        err_abs = (heads.double() - want).abs().max().item()
        err_exp = (exp.double() - want).abs().max().item()
        assert err_abs <= 1.1 * err_exp, (seed, err_abs, err_exp)
        wo = p["wo"]
        want_out = want.reshape(B, 1, H * vh) @ wo.double()
        exp_out = exp.reshape(B, 1, H * vh) @ wo
        err_abs = (out.double() - want_out).abs().max().item()
        err_exp = (exp_out.double() - want_out).abs().max().item()
        assert err_abs <= 1.1 * err_exp, (seed, err_abs, err_exp)


@pytest.mark.parametrize("kv", list(DTYPES))
def test_absorbed_decode_writes_the_expanded_paths_cache(model, kv,
                                                         monkeypatch):
    """The decode step's cache writes are the re-expanded path's, bit for
    bit: the latent and rope key at the position, every other slot as it
    was."""
    cfg, params = model
    p, pos = params[0], SMAX // 2
    x, cache = _inputs(cfg, 0, DTYPES[kv])
    old = {k: v.clone() for k, v in cache.items()}
    absorbed = {k: v.clone() for k, v in cache.items()}
    _decode(cfg, p, x, absorbed, pos, monkeypatch)
    monkeypatch.setattr(L, "_absorbed_attention", reexpanded)
    L.mla_block(x, p, cfg, positions=torch.full((B, 1), pos),
                cache=cache, cache_pos=torch.tensor(pos, dtype=torch.int32))
    for k in cache:
        bits = L._bits(cache[k])
        assert torch.equal(L._bits(absorbed[k]), bits)
        assert not torch.equal(bits[:, pos], L._bits(old[k])[:, pos])
        keep = torch.ones(SMAX, dtype=torch.bool)
        keep[pos] = False
        assert torch.equal(bits[:, keep], L._bits(old[k])[:, keep])


def test_prompt_attention_chunks_a_length_the_chunk_does_not_divide(
        monkeypatch):
    """A prompt whose length the 256-query chunk does not divide (the
    deepseek cells' 3968-token one) attends in chunks too, the last one
    shorter, bit for bit as all its queries at once: the scores of a
    chunk at a time, not of the whole prompt."""
    gen = torch.Generator().manual_seed(5)
    S, Sk = 1100, 1140
    q = torch.randn(2, S, 4, 32, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(2, Sk, 2, 32, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(S)[None].expand(2, S)
    whole = L.attention(q, k, v, q_positions=pos, kv_valid_len=S)
    rows, softmax = [], torch.softmax
    monkeypatch.setattr(torch, "softmax", lambda s, dim: rows.append(
        s.shape[-2]) or softmax(s, dim=dim))
    chunked = L.attention(q, k, v, q_positions=pos, kv_valid_len=S,
                          q_chunk=256)
    assert rows == [256] * 4 + [76]
    assert torch.equal(chunked, whole)
