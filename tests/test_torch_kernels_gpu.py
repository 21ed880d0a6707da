"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and the tier and engine on the card against the CPU.

Needs an NVIDIA GPU with ``nvcc``: every test is marked ``gpu`` and skips
elsewhere.  Imports neither JAX nor the reference package, so it runs on
a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.core import tier  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    bitplane, build, decode_attn, elastic_matmul, kv_delta, lz4, ops,
    pnm_score,
)
from repro_torch.models.model import init_params  # noqa: E402
import torch_kv_score_cases as kv_score_cases  # noqa: E402
import torch_lz4_cases  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    DEFAULT_TIERS, LOSSLESS_POLICY, ServeEngine, WeightStore,
)

pytestmark = pytest.mark.gpu

ATOL, RTOL = 2e-5, 1e-5      # f32 summation order (decode attention)
# elastic matmul: bf16 x bf16 products are exact in f32, so kernel and
# plain version differ only in the order of the f32 sum over K (the
# reference's own test tolerance)
MM_TOL = 1e-5
# every view the tier produces: the policy views, the PNM score view and
# a truncated block's intersection (MAN4 kept, MAN0 asked: cut9 keeps the
# MAN0 guard plane)
VIEWS = [precision.FULL, precision.MAN4, precision.MAN2, precision.MAN0,
         precision.SCORE,
         precision.PrecisionView(r_m=0, d_m=1, name="cut9"),
         precision.PrecisionView(r_m=3, d_m=2, name="cut12")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _kv_bits(n, seed):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(n) * 0.7).astype(np.float32)
    u = (f.view(np.uint32) >> 16).astype(np.uint16)
    u[::97] = 0x7FC0
    u[1::89] = 0xFF80
    return torch.from_numpy(u.view(np.int16).copy())


# the flush slab (131072), a 896 x 4864 weight (4358144), and lengths
# that end inside a thread's 32 elements or a warp's 1024; at 8, 24 and
# 131080, n / 8 is not a multiple of 4, so the rows do not start on a word
PACK_SIZES = [8, 16, 24, 8000, 131072, 131080, 4358144]


@pytest.mark.parametrize("n", PACK_SIZES)
def test_pack_kernel_matches_plain(card, n):
    x = _kv_bits(n, n).to(card)
    before = build.LAUNCHES["bitplane_pack"]
    got = bitplane.pack_planes_u16(x)
    assert torch.equal(got, bitplane.pack_planes_plain(x))
    assert build.LAUNCHES["bitplane_pack"] == before + 1
    assert torch.equal(bitplane.pack_planes_u16(x), got)   # deterministic


@pytest.mark.parametrize("n", [8, 264, 131072, 131080])
def test_pack_kernel_offset_view_and_guards(card, n):
    """A 16-byte aligned view 8 elements into a larger slab, packed into
    rows that sit inside a guarded buffer: the planes are the plain
    version's and no byte past the last row changes."""
    big = _kv_bits(n + 16, n + 1).to(card)
    x = big[8 : 8 + n]
    assert x.data_ptr() % 16 == 0
    out = torch.full((16 * (n // 8) + 64,), 0xA5, dtype=torch.uint8,
                     device=card)
    build.check(build.load("bitplane_pack").pack_planes_u16(
        x.data_ptr(), out.data_ptr(), n, card.index,
        torch.cuda.current_stream(card).cuda_stream), "bitplane_pack")
    want = bitplane.pack_planes_plain(x).reshape(-1)
    assert torch.equal(out[: want.numel()], want)
    assert bool((out[want.numel():] == 0xA5).all())
    assert torch.equal(bitplane.pack_planes_u16(x), want.view(16, n // 8))


def test_pack_kernel_rejects_a_misaligned_slab(card):
    x = _kv_bits(64, 3).to(card)
    with pytest.raises(ValueError):
        bitplane.pack_planes_u16(x[1:57])


PREP_SIZES = [1, 2, 3, 4, 5, 15, 16, 17, 1000, 262144, 262147]


@pytest.mark.parametrize("runb", [True, False])
@pytest.mark.parametrize("n", PREP_SIZES)
def test_prep_kernel_matches_plain(card, n, runb):
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.integers(0, 3, n, dtype=np.uint8)).to(card)
    before = build.LAUNCHES["lz4_prep"]
    got = lz4.lz4_prep(buf, runb=runb)
    assert build.LAUNCHES["lz4_prep"] == before + 1
    want = lz4.prep_plain(buf, runb=runb)
    assert (got[2] is None) == (not runb) == (want[2] is None)
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)
    again = lz4.lz4_prep(buf, runb=runb)                     # deterministic
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("runb", [True, False])
@pytest.mark.parametrize("off", [1, 2, 3, 4, 5, 17])
@pytest.mark.parametrize("n", [1, 3, 7, 129, 1000, 262147])
def test_prep_kernel_at_any_start(card, n, off, runb):
    """A view starting ``off`` bytes into a larger slab (the bytes around
    it nonzero): words, hashes and run flags of the view alone."""
    rng = np.random.default_rng(n + off)
    raw = torch.from_numpy(rng.integers(1, 4, n + off + 7,
                                        dtype=np.uint8)).to(card)
    view = raw[off : off + n]
    got = lz4.lz4_prep(view, runb=runb)
    want = lz4.prep_plain(view.clone(), runb=runb)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("n", [5, 262147])
def test_prep_kernel_writes_only_what_it_is_asked_for(card, n):
    """Outputs inside guarded buffers: no write past n, and with a null
    run-flag pointer none at all (the match path's call)."""
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.integers(0, 3, n, dtype=np.uint8)).to(card)
    lib = build.load("lz4_prep")
    stream = torch.cuda.current_stream(card).cuda_stream
    want = lz4.prep_plain(buf)
    for runb in (True, False):
        outs = [torch.full((n + 64,), -7, dtype=torch.int32, device=card)
                for _ in range(3)]
        build.check(lib.lz4_prep(
            buf.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if runb else None, n, card.index, stream),
            "lz4_prep")
        for i, o in enumerate(outs):
            if i < 2 or runb:
                assert torch.equal(o[:n], want[i])
                assert bool((o[n:] == -7).all())
            else:
                assert bool((o == -7).all())


def test_match_path_asks_prep_for_no_run_flags(card, monkeypatch):
    """``lz4_match`` (serving's match) launches the prep once without run
    flags: the wrapper allocates and returns none."""
    seen = []
    prep = lz4.lz4_prep

    def record(buf, runb=True):
        out = prep(buf, runb=runb)
        seen.append(out[2])
        return out

    monkeypatch.setattr(lz4, "lz4_prep", record)
    buf, starts, ends = torch_lz4_cases.cases()["kv_slab"]
    got = lz4.lz4_match(torch.from_numpy(buf).to(card), starts, ends)
    assert seen == [None]
    want = lz4.match_events_slab(buf, starts, ends, force="numpy")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_match_pipeline_on_card_matches_numpy_twin(card):
    rng = np.random.default_rng(0)
    parts = [np.where(rng.random(4096) < p, rng.integers(0, 256, 4096), 0)
             .astype(np.uint8) for p in (0.0, 0.01, 0.3, 1.0)] * 5
    parts.append(np.tile(rng.integers(0, 256, 13).astype(np.uint8), 300))
    sizes = np.array([p.size for p in parts])
    ends = np.cumsum(sizes)
    starts = ends - sizes
    buf = np.concatenate(parts)
    ref = lz4.match_events_slab(buf, starts, ends, force="numpy")
    got = lz4.match_events_slab(torch.from_numpy(buf).to(card), starts, ends)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


LZ4_CASES = ["kv_slab", "kv_slab_prescreened", "lengths", "gapped",
             "periodic_3900", "long_65537", "far_repeat", "hash_collision",
             "runs", "next_stream", "long_131072"]


@pytest.fixture(scope="module")
def lz4_slabs():
    out = torch_lz4_cases.cases()
    rng = np.random.default_rng(7)
    big = rng.integers(0, 4, 140000, dtype=np.uint8)
    big[1000:90000] = 0
    big[100000:101000] = big[95000:96000]
    out["long_131072"] = (big, np.array([0, 131072]),
                          np.array([131072, 140000]))
    return out


@pytest.mark.parametrize("name", LZ4_CASES)
def test_match_kernel_matches_plain(card, lz4_slabs, name):
    """lz4_match.cu against the plain pipeline on the card and the numpy
    twin, event for event: main-path slabs, stream lengths 0-4096, streams
    of 65537 bytes and more (the global-scratch path), the 0xFFFF window,
    hash collisions, runs and cursors that reach the next stream.  One
    launch of each kernel per call."""
    buf, starts, ends = lz4_slabs[name]
    d = torch.from_numpy(buf).to(card)
    before = dict(build.LAUNCHES)
    got = lz4.lz4_match(d, starts, ends)
    assert build.LAUNCHES["lz4_match"] == before["lz4_match"] + 1
    assert build.LAUNCHES["lz4_prep"] == before["lz4_prep"] + 1
    want = lz4.match_events_slab(buf, starts, ends, force="numpy")
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    if name != "long_131072":     # the plain rounds take minutes there
        for g, p in zip(got, lz4.match_plain(d, starts, ends)):
            np.testing.assert_array_equal(g, p)


def test_match_kernel_rejects_what_it_cannot_take(card, lz4_slabs):
    buf, starts, ends = lz4_slabs["gapped"]
    d = torch.from_numpy(np.repeat(buf, 2)).to(card)
    with pytest.raises(ValueError):
        lz4.lz4_match(d[::2], starts, ends)
    with pytest.raises(TypeError):
        lz4.lz4_match(d.to(torch.int16), starts, ends)
    with pytest.raises(ValueError):
        lz4.lz4_match(d[: buf.size], starts[::-1].copy(), ends[::-1].copy())


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("B,H,KV,hd,S,valid", [
    (1, 14, 2, 64, 640, 576), (2, 14, 2, 64, 200, 200),
    (2, 8, 2, 32, 256, 37), (1, 4, 4, 128, 96, 1), (3, 16, 1, 64, 33, 33),
    # llava-next-34b: 56 query heads over 8 KV heads (a group of 7), hd 128
    (1, 56, 8, 128, 640, 576), (2, 56, 8, 128, 640, 513),
    (1, 56, 8, 128, 96, 1),
])
def test_decode_attention_kernel_matches_plain(card, kv, B, H, KV, hd, S,
                                               valid):
    gen = torch.Generator(device=card).manual_seed(S)
    q = torch.randn((B, H, hd), generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=card)
            .to(torch.bfloat16).to(kv) for _ in range(2))
    got = decode_attn.decode_attention(q, k, v, valid)
    want = decode_attn.decode_attention_plain(q, k, v, valid)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q, k, v, S + 1)


def _attention_inputs(card, B, H, KV, hd, S, kv, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=card)
            .to(torch.bfloat16).to(kv) for _ in range(2))
    return q, k, v


SPLIT = decode_attn.SPLIT_POSITIONS


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("valid", [1, SPLIT - 1, SPLIT, SPLIT + 1,
                                   2 * SPLIT - 1, 2 * SPLIT, 2 * SPLIT + 1,
                                   8 * SPLIT, 8 * SPLIT + 1, 16 * SPLIT,
                                   16 * SPLIT + 1, 575, 576, 577, 640])
def test_decode_attention_split_boundaries(card, kv, valid):
    """The main path's shape, q (1, 14, 64) over a (1, 640, 2, 64) cache,
    at one block, at block boundaries +-1 (up to 16 one-tile blocks, then
    blocks of two tiles) and around 576; two calls give bit-equal outputs
    (fixed merge order, no atomics)."""
    q, k, v = _attention_inputs(card, 1, 14, 2, 64, 640, kv, valid)
    before = build.LAUNCHES["decode_attn"]
    got = decode_attn.decode_attention(q, k, v, valid)
    assert build.LAUNCHES["decode_attn"] == before + 1
    want = decode_attn.decode_attention_plain(q, k, v, valid)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got, decode_attn.decode_attention(q, k, v, valid))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("B,H,KV,hd,S,valid", [
    (1, 16, 2, 128, 32768, 32000),     # long cache: 63 blocks of 512
    (2, 14, 2, 64, 4096, 4096),        # 43 blocks a row, merged in memory
    (4, 32, 2, 32, 1024, 999),
    (1, 14, 2, 64, 2304, 2048),        # the longest a cluster merges
    (1, 14, 2, 64, 2304, 2049),        # 33 blocks merged in device memory
])
def test_decode_attention_long_context(card, kv, B, H, KV, hd, S, valid):
    q, k, v = _attention_inputs(card, B, H, KV, hd, S, kv, S + valid)
    got = decode_attn.decode_attention(q, k, v, valid)
    want = decode_attn.decode_attention_plain(q, k, v, valid)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got, decode_attn.decode_attention(q, k, v, valid))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_attention_at_the_decode_32k_cell(card, kv):
    """The dry run's 16 x 16 decode_32k cell: each rank's 8 rows attend
    over the whole 32768-slot cache gathered over ``model`` — q (8, 14,
    64) over (8, 32768, 2, 64), every slot valid, 16 (row, KV head)
    groups each split across blocks that merge in device memory."""
    q, k, v = _attention_inputs(card, 8, 14, 2, 64, 32768, kv, 25)
    before = build.LAUNCHES["decode_attn"]
    got = decode_attn.decode_attention(q, k, v, 32768, 0.125)
    assert build.LAUNCHES["decode_attn"] == before + 1
    want = decode_attn.decode_attention_plain(q, k, v, 32768, 0.125)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got, decode_attn.decode_attention(q, k, v, 32768,
                                                         0.125))


# the device-length entry (the captured decode step's): [main]'s shape,
# llava-next-34b's and the decode_32k cell's
DEVLEN_SHAPES = {"main": (1, 14, 2, 64, 640), "llava": (1, 56, 8, 128, 640),
                 "decode_32k": (8, 14, 2, 64, 32768)}


def _devlen_lengths(card, shape):
    """1, the first position of the grid's second block, and S."""
    B, H, KV, hd, S = shape
    chunk = decode_attn.split_size(S, B * KV, decode_attn._sms(card.index))
    return (1, chunk + 1, S)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("which", list(DEVLEN_SHAPES))
def test_decode_attention_device_length_matches_plain(card, kv, which):
    """A 0-d int32 length on the card takes the device-length entry
    (counted as ``decode_attn_devlen``): within the f32 tolerance of the
    plain version on the same tensor, bit-equal across two calls, at 1,
    a block boundary and S — blocks past the length give empty partials
    that every merge path (one block, the cluster, device memory) takes
    as nothing."""
    B, H, KV, hd, S = DEVLEN_SHAPES[which]
    q, k, v = _attention_inputs(card, B, H, KV, hd, S, kv, 31)
    for valid in _devlen_lengths(card, DEVLEN_SHAPES[which]):
        length = torch.tensor(valid, dtype=torch.int32, device=card)
        before = dict(build.LAUNCHES)
        got = decode_attn.decode_attention(q, k, v, length)
        assert build.LAUNCHES["decode_attn_devlen"] == \
            before["decode_attn_devlen"] + 1
        assert build.LAUNCHES["decode_attn"] == before["decode_attn"]
        want = decode_attn.decode_attention_plain(q, k, v, length)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert torch.equal(got, decode_attn.decode_attention(q, k, v,
                                                             length))
        torch.testing.assert_close(
            got, decode_attn.decode_attention(q, k, v, valid),
            atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("which", list(DEVLEN_SHAPES))
def test_decode_attention_device_length_replays_in_a_graph(card, which):
    """One capture of the call replays at every length, bit-equal to the
    eager device-length call; a merge through device memory leaves its
    counters at 0 after every replay."""
    B, H, KV, hd, S = DEVLEN_SHAPES[which]
    q, k, v = _attention_inputs(card, B, H, KV, hd, S, torch.bfloat16, 33)
    length = torch.full((), S, dtype=torch.int32, device=card)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        decode_attn.decode_attention(q, k, v, length)
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = decode_attn.decode_attention(q, k, v, length)
    for valid in _devlen_lengths(card, DEVLEN_SHAPES[which]) + (S // 2,):
        length.fill_(valid)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attn.decode_attention(q, k, v,
                                                             length))
        counters = decode_attn._COUNTERS.get((card.index,
                                              stream.cuda_stream))
        assert counters is None or not bool(counters.any())


def test_counters_are_never_allocated_under_capture(card):
    q, k, v = _attention_inputs(card, 8, 14, 2, 64, 32768, torch.bfloat16, 1)
    length = torch.full((), 40, dtype=torch.int32, device=card)
    stream = torch.cuda.Stream(card)      # never used eagerly: no counters
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="merge counters"):
        with torch.cuda.graph(graph, stream=stream):
            decode_attn.decode_attention(q, k, v, length)


SERVED = ["deepseek-v2-lite-16b", "falcon-mamba-7b", "grok-1-314b",
          "nemotron-4-340b", "qwen1.5-32b", "qwen2-0.5b", "stablelm-12b",
          "zamba2-7b"]


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _eager_logits(eng, tok, cache):
    from repro_torch.models.model import decode_step

    pos = torch.tensor(eng.pos, dtype=torch.int32, device=eng.device)
    logits, _ = decode_step(eng.cfg, eng.params, {
        "tokens": torch.from_numpy(tok.astype(np.int64)).to(eng.device),
        "cache_pos": pos}, cache)
    return logits[:, -1].float().cpu().numpy()


@pytest.mark.parametrize("name", SERVED)
def test_engine_graph_replay_equals_eager_step(card, name):
    """Every causal arch the engine serves, at smoke width: the engine
    captures its decode step once, and every replay's logits equal
    ``decode_step`` run eagerly at the same tensor position on a copy of
    the cache, bit for bit; the replay's launches are counted."""
    cfg = smoke_config(ARCHS[name])
    params = init_params(cfg, seed=0, device=card)
    eng = ServeEngine(cfg, params, max_seq=96, page_tokens=16,
                      hbm_kv_budget=1 << 12, device=card)
    prompt = (np.arange(40, dtype=np.int32).reshape(1, 40) * 5) % cfg.vocab
    logits = eng.prefill(prompt)
    build.reset_launches()
    for step in range(10):
        tok = np.array([[int(np.argmax(logits[0]))]], dtype=np.int32)
        saved = dict(build.LAUNCHES)
        want = _eager_logits(eng, tok, _clone_tree(eng.cache))
        build.LAUNCHES.update(saved)
        logits = eng.decode(tok)
        np.testing.assert_array_equal(logits, want)
    assert eng.graph is not None
    # the GQA decoders attend through the kernel once a layer; MLA, the
    # Mamba states and the hybrid's rolling cache in plain PyTorch
    plain = cfg.mla or cfg.ssm or cfg.family == "hybrid"
    attn = 0 if plain else cfg.n_layers
    assert build.LAUNCHES["decode_attn"] == 0
    # 10 replays and the warm-up step before the capture
    assert build.LAUNCHES["decode_attn_devlen"] == 11 * attn
    eng.retire()
    assert eng.graph is None


def test_readback_between_replays_is_what_the_next_replay_attends(card):
    """A window the host writes into the cache between two replays (as
    ``_apply_readback`` writes the tier's readback) is what the next
    replay attends to: its logits equal the eager step over the written
    cache, and differ from the eager step over the cache without it."""
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = init_params(cfg, seed=0, device=card)
    eng = ServeEngine(cfg, params, max_seq=96, page_tokens=16,
                      hbm_kv_budget=1 << 22, device=card)
    prompt = (np.arange(40, dtype=np.int32).reshape(1, 40) * 3) % cfg.vocab
    eng.prefill(prompt)
    tok = np.array([[7]], dtype=np.int32)
    eng.decode(tok)                      # captured and replayed once
    assert eng.graph is not None and eng.stats().spilled_pages == 0
    before = _clone_tree(eng.cache)
    page = eng.pool.page_tokens
    win = eng.cache["layers"]["k"][0, :, 16:16 + page]
    words = (win.cpu().contiguous().view(torch.int16).numpy()
             .view(np.uint16) ^ 0x8000)            # a readback's new words

    class Page:
        kind, layer, start = "k", 0, 16
    eng._apply_readback([Page()], [words.reshape(page, -1)])
    want = _eager_logits(eng, tok, _clone_tree(eng.cache))
    stale = _eager_logits(eng, tok, before)
    got = eng.decode(tok)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, stale)


def test_decode_attention_memory_merge_resets_counters(card):
    """More than 16 blocks a row merge through device memory: the kernel
    sets each row's counter back to 0 once merged, so the wrapper keeps
    one counter buffer per stream and launches no fill per call."""
    q, k, v = _attention_inputs(card, 2, 14, 2, 64, 8192, torch.bfloat16, 7)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    got = decode_attn.decode_attention(q, k, v, 8000)
    counters = decode_attn._COUNTERS[(q.device.index, stream)]
    again = decode_attn.decode_attention(q, k, v, 8000)
    assert decode_attn._COUNTERS[(q.device.index, stream)] is counters
    assert not bool(counters.any())
    assert torch.equal(got, again)
    want = decode_attn.decode_attention_plain(q, k, v, 8000)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _scores_equal(a, b):
    """Bitwise equal, NaN matching NaN (payloads may differ)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("P,T,C", [(64, 64, 128), (24, 64, 128), (5, 16, 64),
                                   (3, 7, 40), (2, 3, 1024), (1, 1, 1),
                                   (144, 64, 512), (26, 64, 512)])
def test_pnm_score_kernel_matches_plain(card, P, T, C):
    """Bit-equal to the plain version (same summation order), with ragged
    valid counts, an empty page, NaN and inf rows."""
    rng = np.random.default_rng(P * T + C)
    x = (rng.standard_normal((P, T, C)) * 0.7).astype(np.float32)
    u = (x.view(np.uint32) >> 16).astype(np.uint16)
    valid = rng.integers(0, T + 1, P).astype(np.int32)
    valid[0] = 0
    if P > 2:
        valid[1:3] = T
        u[1, 0, 0] = 0x7FC0                      # NaN in a valid row
        u[2, T - 1, C - 1] = 0x7F80              # +inf in a valid row
    pages = torch.from_numpy(u.view(np.int16)).to(card)
    digest = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(
        card)
    v = torch.from_numpy(valid).to(card)
    before = build.LAUNCHES["pnm_score"]
    got = pnm_score.page_scores(pages, v, digest)
    assert build.LAUNCHES["pnm_score"] == before + 1
    want = pnm_score.page_scores_plain(pages, v, digest)
    assert _scores_equal(got, want)
    assert float(got[0]) == float("-inf")
    if P > 2:
        assert bool(torch.isnan(got[1]))


def test_pnm_score_batch_independent_and_ties(card):
    """A page scores bitwise the same alone and inside a larger, other-
    padded batch; byte-identical pages score equal."""
    rng = np.random.default_rng(3)
    pages = [(rng.standard_normal((t, 128)).astype(np.float32).view(np.uint32)
              >> 16).astype(np.uint16) for t in (64, 9, 64, 1)]
    pages.append(pages[0].copy())
    digest = rng.standard_normal(128).astype(np.float32)
    batch = pnm_score.page_scores_u16(pages, digest, card)
    big = pnm_score.page_scores_u16(pages[::-1] + [np.zeros((300, 128),
                                                            np.uint16)],
                                    digest, card)[:-1][::-1]
    alone = np.array([pnm_score.page_scores_u16([p], digest, card)[0]
                      for p in pages])
    cpu = pnm_score.page_scores_u16(pages, digest, "cpu")
    for other in (big, alone, cpu):
        assert other.tobytes() == batch.tobytes()
    assert batch[0] == batch[4]


@pytest.mark.parametrize("P,T,C", kv_score_cases.SCORE_SHAPES_CARD)
def test_pnm_score_kernel_edge_pages(card, P, T, C):
    """The served and long-context gathers, P above the SM count and past
    a full grid's slots, T a multiple of no row group, C from 1 to 1024:
    bit-equal to the plain version, one launch, -inf for the empty page,
    NaN and inf past valid ignored."""
    u, valid, digest = kv_score_cases.score_case(P, T, C, seed=P + T + C)
    pages = torch.from_numpy(u.view(np.int16)).to(card)
    v = torch.from_numpy(valid).to(card)
    d = torch.from_numpy(digest).to(card)
    before = build.LAUNCHES["pnm_score"]
    got = pnm_score.page_scores(pages, v, d)
    assert build.LAUNCHES["pnm_score"] == before + 1
    assert _scores_equal(got, pnm_score.page_scores_plain(pages, v, d))
    assert float(got[0]) == float("-inf") and bool(torch.isnan(got[1]))
    if P > 4:
        assert bool(torch.isfinite(got[3:5]).all()) or T == 1


@pytest.mark.parametrize("P,T,C", [(64, 64, 128), (6, 9, 40), (3, 4, 1024),
                                   (5, 7, 1)])
def test_pnm_score_kernel_offset_views(card, P, T, C):
    """Inputs at an offset into larger buffers (pages 2 bytes past a
    16-byte boundary: no bulk copy) score as the aligned ones do."""
    u, valid, digest = kv_score_cases.score_case(P, T, C, seed=P * C)
    pages = torch.from_numpy(u.view(np.int16)).to(card)
    v = torch.from_numpy(valid).to(card)
    d = torch.from_numpy(digest).to(card)
    want = pnm_score.page_scores(pages, v, d)
    big = torch.zeros(pages.numel() + 1, dtype=torch.int16, device=card)
    big[1:] = pages.reshape(-1)
    vbig = torch.zeros(P + 1, dtype=torch.int32, device=card)
    vbig[1:] = v
    dbig = torch.zeros(C + 1, dtype=torch.float32, device=card)
    dbig[1:] = d
    got = pnm_score.page_scores(big[1:].view(P, T, C), vbig[1:], dbig[1:])
    assert _scores_equal(got, want)
    assert _scores_equal(got, pnm_score.page_scores_plain(pages, v, d))


def test_pnm_gather_on_card_identical_to_cpu(card):
    rng = np.random.default_rng(5)
    pages = [((rng.standard_normal((64, 128)) * 0.5).astype(np.float32)
              .view(np.uint32) >> 16).astype(np.uint16) for _ in range(24)]
    keys = tuple(f"p{i}" for i in range(24))
    digest = rng.standard_normal(128).astype(np.float32)
    recs = {}
    for dev in (card, "cpu"):
        t = tier.make_device("trace", device=dev)
        t.submit([tier.WriteReq(k, p, kind=tier.KV)
                  for k, p in zip(keys, pages)])
        recs[str(dev)] = t.submit([tier.GatherReq(keys, digest, k=k)
                                   for k in (0, 5, 24)])
    for a, b in zip(recs[str(card)], recs["cpu"], strict=True):
        skip = ("data", "gather")
        assert {k: v for k, v in vars(a).items() if k not in skip} == \
            {k: v for k, v in vars(b).items() if k not in skip}
        assert a.gather.scores.tobytes() == b.gather.scores.tobytes()
        assert (a.gather.keys, a.gather.indices) == \
            (b.gather.keys, b.gather.indices)
        for x, y in zip(a.gather.data, b.gather.data, strict=True):
            np.testing.assert_array_equal(x, y)


def test_tier_on_card_identical_to_cpu(card):
    rng = np.random.default_rng(4)
    pages = [((rng.standard_normal((64, 128)) * 0.5).astype(np.float32)
              .view(np.uint32) >> 16).astype(np.uint16) for _ in range(20)]
    pages[3][::7, 5] = 0x7FC1                # NaN, payload in a dropped plane
    pages[4][::5, 9] = 0xFF80                # -Inf
    pages[5][:, 2] = 0x407F                  # MAN4 round carries into exp
    pages[6][:, 3] = 0x7F7F                  # rounds up to saturate at Inf
    views = [v for v in VIEWS if v.name[:3] != "cut"]
    recs = {}
    for dev in (card, "cpu"):
        t = tier.make_device("trace", device=dev)
        recs[str(dev)] = t.submit(
            [tier.WriteReq(f"p{i}", p, kind=tier.KV) for i, p in enumerate(pages)]
            + [tier.WriteReq("w", pages[7].ravel()),
               tier.WriteReq("part", pages[8][:37], kind=tier.KV)]
        ) + t.submit([tier.ReadReq(f"p{i}", kind=tier.KV, view=v)
                      for i in range(20) for v in views]
                     + [tier.ReadReq("w", view=v) for v in views]
                     + [tier.ReadReq("part", kind=tier.KV, view=v)
                        for v in views])
        # truncated blocks: a read at (r_m 2, d_m 4) of a MAN4 block is
        # served at their intersection, cut11
        t.truncate_planes(["p1", "w"], precision.MAN4)
        wide = precision.PrecisionView(r_m=2, d_m=4, name="wide")
        recs[str(dev)] += t.submit([tier.ReadReq(k, kind=kind, view=v)
                                    for k, kind in (("p1", tier.KV),
                                                    ("w", tier.TENSOR))
                                    for v in views + [wide]])
    for a, b in zip(recs[str(card)], recs["cpu"], strict=True):
        assert {k: v for k, v in vars(a).items() if k != "data"} == \
            {k: v for k, v in vars(b).items() if k != "data"}
        if b.data is not None:
            np.testing.assert_array_equal(a.data, b.data)


def test_engine_on_card_runs_every_kernel(card):
    """Classic readback and the PNM path (attention importance, 2 shards)
    on the card: together they launch every serving kernel (all but the
    elastic matmul and the standalone KV inverse, which only the kernel
    API reaches, and decode attention's host-length entry, which the dry
    run's step takes: the engine's captured step takes the device
    length)."""
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    params = init_params(cfg, seed=0, device=card)
    build.reset_launches()
    prompt = (np.arange(48, dtype=np.int32).reshape(1, 48) * 3) % cfg.vocab
    for pnm in ({}, dict(pnm_topk=2, importance="attention",
                         device_kind=tier.make_device("trace", shards=2,
                                                      device=card))):
        eng = ServeEngine(cfg, params, max_seq=96, page_tokens=16,
                          hbm_kv_budget=1 << 12, policy=LOSSLESS_POLICY,
                          device=card, **pnm)
        toks = eng.generate(prompt, 12)
        assert toks.shape == (1, 12) and toks.max() < cfg.vocab
        assert eng.stats().spilled_pages > 0
    assert eng.pool.pages_gathered > 0
    # the KV read is one fused launch per window group (bitplane_unpack);
    # the standalone inverse, like the elastic matmul, is the kernel API's
    assert build.LAUNCHES["bitplane_unpack"] > 0, build.LAUNCHES
    assert build.LAUNCHES["kv_delta_inv"] == 0, build.LAUNCHES
    # decode attention launches at the position on the device only (the
    # captured step): the host-length entry is the dry run's
    assert build.LAUNCHES["decode_attn"] == 0, build.LAUNCHES
    assert all(build.LAUNCHES[name] > 0 for name in build.KERNELS
               if name not in ("elastic_matmul", "kv_delta_inv",
                               "decode_attn")), \
        build.LAUNCHES


def _patterns(shape, seed):
    """bf16 patterns of KV-like magnitudes with every special the round
    treats apart: NaN with its payload only in low planes, +-Inf, a round
    that carries into the exponent and one that saturates at Inf."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(shape) * np.exp(rng.uniform(-3, 3, shape[-1])))
    u = (f.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    flat = u.reshape(-1)
    flat[::97] = 0x7F81
    flat[1::89] = 0xFF80
    flat[2::83] = 0x7F80
    flat[3::79] = 0x407F
    flat[4::73] = 0x7F7F
    flat[5::71] = 0xFFC1
    return u


@pytest.mark.parametrize("view", VIEWS, ids=lambda v: v.name)
@pytest.mark.parametrize("nbytes", [1, 7, 8192])
def test_unpack_kernel_matches_plain(card, view, nbytes):
    rng = np.random.default_rng(nbytes)
    ids = view.fetched_planes()
    rows = torch.from_numpy(rng.integers(0, 256, (len(ids), nbytes),
                                         dtype=np.uint8)).to(card)
    for v in (None, view):
        before = build.LAUNCHES["bitplane_unpack"]
        got = bitplane.unpack_planes(rows, ids, v)
        assert build.LAUNCHES["bitplane_unpack"] == before + 1
        want = bitplane.unpack_planes_plain(rows, ids,
                                            bitplane.view_round_params(v))
        assert torch.equal(got, want)


@pytest.mark.parametrize("P", range(1, 17))
def test_unpack_kernel_every_plane_count(card, P):
    rng = np.random.default_rng(P)
    ids = [int(i) for i in rng.permutation(16)[:P]]
    rows = torch.from_numpy(rng.integers(0, 256, (P, 8192),
                                         dtype=np.uint8)).to(card)
    for v in (None, precision.MAN4):
        got = bitplane.unpack_planes(rows, ids, v)
        want = bitplane.unpack_planes_plain(rows, ids,
                                            bitplane.view_round_params(v))
        assert torch.equal(got, want)


# the tier's window groups: a decode slab's 8 full windows, partial
# flushes (channel boundaries inside bytes) and an odd channel count
KV_SHAPES = [(8, 64, 128), (1, 17, 128), (2, 33, 40), (3, 37, 40), (2, 7, 5),
             (2, 100, 24), (2, 64, 512)]


def _kv_slab(card, B, n, C, P, seed, ids=None):
    """Transformed windows with every special, packed into one slab of
    plane rows with random bytes around each (members apart), members in
    shuffled order: (windows, fetched rows, plane ids, starts, beta)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_patterns((B, n, C), seed).view(np.int16))
    cm, beta = kv_delta.kv_forward_plain(x)
    L = n * C
    segs, starts, pos = [], [], 0
    for b in range(B):
        gap = 8 * int(rng.integers(1, 5))
        pad = -L % 8
        segs += [rng.integers(0, 1 << 16, gap), cm[b].reshape(-1).numpy()
                 .view(np.uint16), rng.integers(0, 1 << 16, pad)]
        starts.append(pos + gap)
        pos += gap + L + pad
    segs.append(rng.integers(0, 1 << 16, 16))
    flat = np.concatenate([np.asarray(s, dtype=np.uint16) for s in segs])
    planes = bitplane.pack_planes_plain(torch.from_numpy(flat.view(np.int16)))
    if ids is None:
        ids = [int(i) for i in rng.permutation(16)[:P]]
    order = [int(i) for i in rng.permutation(B)]
    return (x[order].to(card), planes[ids].contiguous().to(card), ids,
            [starts[i] for i in order], beta[order].contiguous().to(card))


@pytest.mark.parametrize("view", [None] + VIEWS,
                         ids=lambda v: "exact" if v is None else v.name)
@pytest.mark.parametrize("B,n,C", KV_SHAPES)
def test_kv_read_kernel_matches_plain(card, view, B, n, C):
    """The fused read at every view, over the view's own planes of
    windows stored as the tier stores them: bit-equal to the plain
    version, one launch, and lossless at the full view."""
    ids = list((view or precision.FULL).fetched_planes())
    x, rows, ids, starts, beta = _kv_slab(card, B, n, C, len(ids), n * C,
                                          ids)
    before = dict(build.LAUNCHES)
    got = bitplane.unpack_kv_windows(rows, ids, starts, n, C, beta, view)
    assert build.LAUNCHES["bitplane_unpack"] == \
        before["bitplane_unpack"] + 1
    assert build.LAUNCHES["kv_delta_inv"] == before["kv_delta_inv"]
    want = bitplane.unpack_kv_windows_plain(rows, ids, starts, n, C, beta,
                                            view)
    assert torch.equal(got, want)
    if view is None or view.is_full:
        assert torch.equal(got, x)


@pytest.mark.parametrize("P", range(1, 17))
@pytest.mark.parametrize("B,n,C", KV_SHAPES)
def test_kv_read_kernel_every_plane_count(card, P, B, n, C):
    """Any P of the 16 planes, in any row order, members apart: the
    kernel's P template instance against the plain version, unrounded and
    with a round."""
    _, rows, ids, starts, beta = _kv_slab(card, B, n, C, P, 31 * P + n)
    for view in (None, precision.MAN4, precision.SCORE):
        got = bitplane.unpack_kv_windows(rows, ids, starts, n, C, beta, view)
        want = bitplane.unpack_kv_windows_plain(rows, ids, starts, n, C,
                                                beta, view)
        assert torch.equal(got, want), view


def test_kv_read_kernel_more_windows_than_a_launch_takes(card):
    """A group of more windows than one launch's parameters hold goes in
    launches of KV_READ_WINDOWS, each counted."""
    B = bitplane.KV_READ_WINDOWS + 44
    _, rows, ids, starts, beta = _kv_slab(card, B, 1, 8, 14, 9)
    before = build.LAUNCHES["bitplane_unpack"]
    got = bitplane.unpack_kv_windows(rows, ids, starts, 1, 8, beta,
                                     precision.MAN2)
    assert build.LAUNCHES["bitplane_unpack"] == before + 2
    assert torch.equal(got, bitplane.unpack_kv_windows_plain(
        rows, ids, starts, 1, 8, beta, precision.MAN2))


def test_kv_read_kernel_deterministic(card):
    _, rows, ids, starts, beta = _kv_slab(card, 8, 64, 128, 14, 7)
    a = bitplane.unpack_kv_windows(rows, ids, starts, 64, 128, beta,
                                   precision.MAN4)
    b = bitplane.unpack_kv_windows(rows, ids, starts, 64, 128, beta,
                                   precision.MAN4)
    assert torch.equal(a, b)


def test_non_kv_tier_read_launches_the_standalone_unpack(card, monkeypatch):
    """A ``bitplane`` tier (no KV transform) reads through the standalone
    unpack + round, never the fused KV read, and returns the CPU tier's
    words at every view."""
    fused = []
    monkeypatch.setattr(bitplane, "unpack_kv_windows",
                        lambda *a, **kw: fused.append(a))
    w = _patterns((96, 128), 12).ravel()
    views = [v for v in VIEWS if v.name[:3] != "cut"]
    data = {}
    for dev in (card, "cpu"):
        t = tier.TierStore("bitplane", device=dev)
        t.submit([tier.WriteReq("w", w),
                  tier.WriteReq("kv", w[:64 * 128].reshape(64, 128),
                                kind=tier.KV)])
        before = dict(build.LAUNCHES)
        recs = t.submit([tier.ReadReq(k, kind=kind, view=v)
                         for k, kind in (("w", tier.TENSOR), ("kv", tier.KV))
                         for v in views])
        data[str(dev)] = [r.data for r in recs]
        if dev == card:
            assert build.LAUNCHES["bitplane_unpack"] > \
                before["bitplane_unpack"]
            assert build.LAUNCHES["kv_delta_inv"] == before["kv_delta_inv"]
    assert not fused
    for a, b in zip(data[str(card)], data["cpu"], strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B,n,C", [(128, 64, 128), (1, 17, 128), (3, 37, 40),
                                   (2, 256, 256), (1, 1, 1), (144, 64, 512),
                                   (26, 64, 512)])
def test_kv_forward_kernel_matches_plain(card, B, n, C):
    x = torch.from_numpy(_patterns((B, n, C), n * C).view(np.int16)).to(card)
    if n >= 4:                           # exponent ties: smallest wins
        x[0, : n // 2, 0] = 0x3F80
        x[0, n // 2 : 2 * (n // 2), 0] = 0x4000
    got, beta = kv_delta.kv_forward(x)
    want, want_beta = kv_delta.kv_forward_plain(x)
    assert torch.equal(beta, want_beta) and torch.equal(got, want)
    if n >= 4:
        assert int(beta[0, 0]) == 127
    arb = torch.from_numpy(np.random.default_rng(C).integers(
        0, 256, (B, C), dtype=np.uint8)).to(card)
    got, _ = kv_delta.kv_forward(x, arb)
    assert torch.equal(got, kv_delta.kv_forward_plain(x, arb)[0])
    assert torch.equal(kv_delta.kv_inverse(got, arb), x)


@pytest.mark.parametrize("B,n,C", kv_score_cases.KV_SHAPES_CARD)
def test_kv_forward_kernel_edge_windows(card, B, n, C):
    """The served and long-context flushes, n across a token group and
    the tile, B from 1 to 2048, C from 1 to 1024, a many-way tie, an
    all-distinct channel, exponents 0 and 255 tied: out and beta
    bit-equal to the plain version, in one launch; the given-beta path
    too."""
    x = torch.from_numpy(kv_score_cases.kv_case(B, n, C, seed=B + n + C)
                         .view(np.int16)).to(card)
    before = build.LAUNCHES["kv_delta_fwd"]
    got, beta = kv_delta.kv_forward(x)
    assert build.LAUNCHES["kv_delta_fwd"] == before + 1
    want, want_beta = kv_delta.kv_forward_plain(x)
    assert torch.equal(beta, want_beta) and torch.equal(got, want)
    if n >= 4:
        assert int(beta[0, 0]) == kv_score_cases.tie_winner(n)
    given, _ = kv_delta.kv_forward(x, beta)
    assert torch.equal(given, want)


@pytest.mark.parametrize("B,n,C", [(128, 64, 128), (3, 37, 40), (2, 300, 40),
                                   (1, 17, 1)])
def test_kv_forward_kernel_offset_view(card, B, n, C):
    """Windows 2 bytes past a 16-byte boundary (no vector loads) and a
    given beta at an odd offset: as from aligned buffers."""
    u = kv_score_cases.kv_case(B, n, C, seed=n)
    x = torch.from_numpy(u.view(np.int16)).to(card)
    big = torch.zeros(x.numel() + 1, dtype=torch.int16, device=card)
    big[1:] = x.reshape(-1)
    got, beta = kv_delta.kv_forward(big[1:].view(B, n, C))
    want, want_beta = kv_delta.kv_forward_plain(x)
    assert torch.equal(beta, want_beta) and torch.equal(got, want)
    bbig = torch.zeros(B * C + 1, dtype=torch.uint8, device=card)
    bbig[1:] = beta.reshape(-1)
    given, _ = kv_delta.kv_forward(big[1:].view(B, n, C), bbig[1:].view(B, C))
    assert torch.equal(given, want)


def test_kv_forward_kernel_counts_past_24_bits(card):
    """A channel whose modal count needs more than 24 bits (the wide-key
    kernel): the mode still wins over an exponent seen less often."""
    n = (1 << 24) + 3
    u = np.full((1, n, 1), 0x3F80, np.uint16)          # exponent 127
    u[0, : (1 << 23)] = 0x4000                          # exponent 128
    x = torch.from_numpy(u.view(np.int16)).to(card)
    got, beta = kv_delta.kv_forward(x)
    want, want_beta = kv_delta.kv_forward_plain(x)
    assert int(beta[0, 0]) == 127
    assert torch.equal(beta, want_beta) and torch.equal(got, want)


@pytest.mark.parametrize("view", [None] + VIEWS,
                         ids=lambda v: "exact" if v is None else v.name)
@pytest.mark.parametrize("B,n,C", KV_SHAPES)
def test_kv_inverse_kernel_matches_plain(card, view, B, n, C):
    cm = torch.from_numpy(_patterns((B, C, n), B + n).view(np.int16)).to(card)
    beta = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (B, C), dtype=np.uint8)).to(card)
    before = build.LAUNCHES["kv_delta_inv"]
    got = kv_delta.kv_inverse(cm, beta, view)
    assert build.LAUNCHES["kv_delta_inv"] == before + 1
    assert torch.equal(got, kv_delta.kv_inverse_plain(cm, beta, view))


@pytest.mark.parametrize("M,K,N", [(1, 896, 4864), (16, 896, 4864),
                                   (3, 64, 40), (33, 264, 129)])
@pytest.mark.parametrize("r_m,d_m", [(7, 0), (4, 1), (0, 1), (3, 0)])
def test_elastic_matmul_kernel_matches_plain(card, M, K, N, r_m, d_m):
    rng = np.random.default_rng(M * K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        card, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(
        np.float32)).to(card, torch.bfloat16)
    planes = elastic_matmul.pack_weights_kmajor(w)
    ids = ops.fetch_planes(8, r_m, d_m)
    rnd = bitplane.round_params(8, r_m, d_m)
    before = build.LAUNCHES["elastic_matmul"]
    got = elastic_matmul.elastic_matmul_planes(x, planes[ids].contiguous(),
                                               ids, rnd)
    assert build.LAUNCHES["elastic_matmul"] == before + 1
    want = elastic_matmul.elastic_matmul_plain(x, planes[ids], ids, rnd)
    torch.testing.assert_close(got, want, atol=MM_TOL, rtol=MM_TOL)
    if (r_m, d_m) == (7, 0):
        torch.testing.assert_close(got, x.float() @ w.float(), atol=MM_TOL,
                                   rtol=MM_TOL)


def _matmul_inputs(card, M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        card, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(
        np.float32)).to(card, torch.bfloat16)
    return x, w, elastic_matmul.pack_weights_kmajor(w)


# every view with r_e = 8: P = 9 + r_m + d_m fetched planes, 9 to 16
EVERY_VIEW = [(r_m, d_m) for r_m in range(8) for d_m in range(8 - r_m)]


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("r_m,d_m", EVERY_VIEW,
                         ids=[f"rm{r}dm{d}" for r, d in EVERY_VIEW])
def test_elastic_matmul_every_plane_count(card, M, r_m, d_m):
    """The MLP up-projection (896, 4864) at every view, its planes handed
    in the view's order and in the stack's own order (read in place)."""
    x, w, planes = _matmul_inputs(card, M, 896, 4864, 7 * r_m + d_m)
    ids = ops.fetch_planes(8, r_m, d_m)
    rnd = bitplane.round_params(8, r_m, d_m)
    want = elastic_matmul.elastic_matmul_plain(x, planes[ids], ids, rnd)
    got = elastic_matmul.elastic_matmul_planes(x, planes[ids].contiguous(),
                                               ids, rnd)
    torch.testing.assert_close(got, want, atol=MM_TOL, rtol=MM_TOL)
    first = 16 - len(ids)
    stack = elastic_matmul.elastic_matmul_planes(
        x, planes[first:], list(range(first, 16)), rnd)
    torch.testing.assert_close(stack, want, atol=MM_TOL, rtol=MM_TOL)
    if r_m == 7:
        torch.testing.assert_close(got, x.float() @ w.float(), atol=MM_TOL,
                                   rtol=MM_TOL)


@pytest.mark.parametrize("M", [1, 3, 16, 33])
@pytest.mark.parametrize("K,N", [(8, 129), (8, 40), (264, 129), (896, 40)])
@pytest.mark.parametrize("r_m,d_m", [(7, 0), (2, 3), (0, 0)])
def test_elastic_matmul_ragged(card, M, K, N, r_m, d_m):
    """Ragged N (not a multiple of 4: byte loads; of 32: a part block),
    K of one byte row, M of one, part of and more than one row tile."""
    x, _, planes = _matmul_inputs(card, M, K, N, M * K + N)
    ids = ops.fetch_planes(8, r_m, d_m)
    rnd = bitplane.round_params(8, r_m, d_m)
    got = elastic_matmul.elastic_matmul_planes(x, planes[ids].contiguous(),
                                               ids, rnd)
    want = elastic_matmul.elastic_matmul_plain(x, planes[ids], ids, rnd)
    torch.testing.assert_close(got, want, atol=MM_TOL, rtol=MM_TOL)


def test_elastic_matmul_rejects_planes_it_cannot_read(card):
    x, _, planes = _matmul_inputs(card, 1, 64, 32, 0)
    rnd = bitplane.round_params(8, 7, 0)
    with pytest.raises(ValueError):       # not the top planes
        elastic_matmul.elastic_matmul_planes(
            x, planes[:9].contiguous(), list(range(9)), rnd)
    with pytest.raises(ValueError):       # fewer than sign + exponent
        elastic_matmul.elastic_matmul_planes(
            x, planes[8:].contiguous(), list(range(8, 16)), rnd)


@pytest.mark.parametrize("M", [1, 16])
def test_kernel_api_elastic_matmul_copies_no_planes(card, M):
    """``ops.elastic_matmul`` hands the kernel the stack's own top planes:
    the only memory the call allocates is its (M, N) output."""
    x, w, planes = _matmul_inputs(card, M, 896, 4864, M)
    ops.elastic_matmul(x, planes, 4, 1)            # build and load first
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.elastic_matmul(x, planes, 4, 1)
    torch.cuda.synchronize()
    out_bytes = -(-out.numel() * 4 // 512) * 512    # allocator granule
    assert torch.cuda.max_memory_allocated() - before == out_bytes
    ids = ops.fetch_planes(8, 4, 1)
    want = elastic_matmul.elastic_matmul_plain(x, planes[ids], ids,
                                               bitplane.round_params(8, 4, 1))
    torch.testing.assert_close(out, want, atol=MM_TOL, rtol=MM_TOL)


def test_kernel_api_on_card_matches_cpu(card):
    """Every function of ``kernels.ops`` gives on the card what it gives
    on the CPU."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_patterns((64, 256), 1).view(np.int16))
    beta = torch.from_numpy(rng.integers(0, 256, 256, dtype=np.uint8))
    xm = torch.from_numpy(rng.standard_normal((16, 128)).astype(
        np.float32)).to(torch.bfloat16)
    wp = elastic_matmul.pack_weights_kmajor(torch.from_numpy(
        rng.standard_normal((128, 96)).astype(np.float32)))
    q = torch.from_numpy(rng.standard_normal((1, 14, 64)).astype(
        np.float32)).to(torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((1, 80, 2, 64)).astype(
        np.float32)).to(torch.bfloat16)
    calls = [
        lambda d: ops.bitplane_pack(x.to(d)),
        lambda d: ops.elastic_unpack(ops.bitplane_pack(x.to(d)), 8, 4, 1),
        lambda d: ops.kv_transform(x.to(d), beta.to(d)),
        lambda d: ops.kv_transform_inv(x.to(d).T.contiguous(), beta.to(d)),
        lambda d: ops.elastic_matmul(xm.to(d), wp.to(d), 4, 1),
        lambda d: ops.decode_attention(q.to(d), kv.to(d), kv.to(d), 77),
    ]
    for i, call in enumerate(calls):
        got, want = call(card).cpu(), call("cpu")
        if got.dtype.is_floating_point:
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        else:
            assert torch.equal(got, want), i


# ---------------------------------------------------------------------------
# the weight path: the standalone unpack at a weight, the per-block
# encoder, the weight store card vs CPU
# ---------------------------------------------------------------------------

WEIGHT = (896, 4864)          # qwen2-0.5b's MLP up-projection
DECODE_SLAB = 64 * 1024       # BitplaneLayout.SLAB_ELEMS


def _weight(card, shape=WEIGHT, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    w = torch.randn(shape, generator=gen, device=card) / shape[0] ** 0.5
    return w.to(torch.bfloat16)


def _fetched_mask(view) -> int:
    return sum(1 << p for p in view.fetched_planes())


@pytest.mark.parametrize("view", [v for _, v in DEFAULT_TIERS],
                         ids=lambda v: v.name)
def test_unpack_kernel_at_a_weight(card, view):
    """The standalone unpack + round at a whole 896 x 4864 weight's plane
    rows and at one 64 Ki-element decode slab of it, at each view of the
    weight store's tiers: the plain version's words, which are the
    source words' fetched planes rounded to the view."""
    w = _weight(card).view(torch.int16).reshape(-1)
    planes = bitplane.pack_planes_u16(w)
    ids = view.fetched_planes()
    rnd = bitplane.view_round_params(view)
    for nbytes in (planes.shape[1], DECODE_SLAB // 8):
        rows = planes[list(ids), :nbytes].contiguous()
        before = build.LAUNCHES["bitplane_unpack"]
        got = bitplane.unpack_planes(rows, ids, view)
        assert build.LAUNCHES["bitplane_unpack"] == before + 1
        assert torch.equal(got, bitplane.unpack_planes_plain(rows, ids, rnd))
        src = (w[: 8 * nbytes].to(torch.int32) & 0xFFFF) & _fetched_mask(view)
        assert torch.equal(got, bitplane.to_int16(
            bitplane.view_round_plain(src, rnd)))


def test_scalar_encoder_pack_on_card_matches_the_slab_pack(card,
                                                          monkeypatch):
    """``TierStore(batched_encode=False)`` packs each block in a launch of
    its own and runs the LZ4 prep and match on the card for each block
    with a plane stream the pre-screen keeps; its planes, payloads and
    receipts equal the batched slab pack's and the CPU's."""
    from repro_torch.core import codec as codecs

    w = _weight(card, (48, 700), seed=3).view(torch.int16).cpu().numpy()
    kv = _patterns((64, 128), 4)
    writes = [tier.WriteReq("w", w.view(np.uint16)),
              tier.WriteReq("kv", kv, kind=tier.KV)]
    # the CPU store's match calls: one per block with a kept stream
    matched = []
    match = codecs.klz4.match_events_slab
    state = {}
    for name, dev, batched in (("cpu", "cpu", False),
                               ("scalar", card, False),
                               ("batched", card, True)):
        t = tier.TierStore("bitplane-kv", device=dev, batched_encode=batched)
        monkeypatch.setattr(codecs.klz4, "match_events_slab",
                            lambda *a, **kw: matched.append(name)
                            or match(*a, **kw))
        before = dict(build.LAUNCHES)
        recs = t.submit(writes)
        monkeypatch.setattr(codecs.klz4, "match_events_slab", match)
        got = {k: build.LAUNCHES[k] - before[k] for k in before}
        blocks = sum(r.blocks for r in recs)
        if name == "scalar":
            n_match = matched.count("cpu")
            assert got["bitplane_pack"] == blocks == 18
            assert got["kv_delta_fwd"] == 1
            assert 0 < got["lz4_prep"] == got["lz4_match"] == n_match \
                == matched.count("scalar") <= blocks
        elif name == "batched":
            assert got["bitplane_pack"] == 1
            assert got["lz4_prep"] == got["lz4_match"] == 1
        state[name] = ([(k, [(b.payloads, b.flags) for b in bl])
                        for k, bl in t._tensors.items()],
                       [{f: v for f, v in vars(r).items() if f != "data"}
                        for r in recs])
    assert state["scalar"] == state["batched"] == state["cpu"]
    flat = torch.from_numpy(w.ravel()).to(card)
    slab = bitplane.pack_planes_u16(flat)
    for i in range(0, flat.numel(), tier.BLOCK_ELEMS):
        blk = flat[i : i + tier.BLOCK_ELEMS]
        if blk.numel() % 8 == 0:
            assert torch.equal(bitplane.pack_planes_u16(blk.contiguous()),
                               slab[:, i // 8 : (i + blk.numel()) // 8])


def test_weight_store_on_card_matches_cpu(card):
    """A weight load and fetch through the store on the card: receipts,
    stored bytes and words equal the CPU store's; every decode slab is
    one standalone unpack; no KV kernel launches."""
    units = {f"L0.{n}": (_weight(card, shape, seed=i), float(7 - i))
             for i, (n, shape) in enumerate((("wq", (896, 896)),
                                             ("wk", (896, 128)),
                                             ("w1", (896, 4864))))}
    out = {}
    for dev in (card, "cpu"):
        ws = WeightStore("trace", device=dev)
        ws.put_many({k: (w.to(dev), imp) for k, (w, imp) in units.items()})
        before = dict(build.LAUNCHES)
        got = ws.fetch_all()
        launches = {k: build.LAUNCHES[k] - before[k] for k in before}
        out[str(dev)] = (got, dict(vars(ws.stats)), launches)
    (gc, sc, lc), (gp, sp, _) = out[str(card)], out["cpu"]
    assert sc == sp
    for k, t in gc.items():
        assert t.device.type == "cuda" and t.dtype == torch.bfloat16
        assert torch.equal(t.cpu().view(torch.int16),
                           gp[k].view(torch.int16))
    n = sum(w.numel() for w, _ in units.values())
    assert lc["bitplane_unpack"] >= -(-n // DECODE_SLAB)
    assert lc["kv_delta_inv"] == lc["kv_delta_fwd"] == 0


def test_moe_routing_on_card_matches_cpu(card):
    """The router's stable descending sort on the card: tied experts
    (duplicated router columns) resolve to the lower index as on the CPU,
    and the capacity slots and drops equal the CPU's.  Both route the
    card's bf16 logits (an identity times them, which is exact), so the
    matmul's summation order cannot differ."""
    from repro_torch.models import layers

    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.standard_normal((512, 256)).astype(
        np.float32)).to(torch.bfloat16).to(card)
    router = torch.from_numpy((rng.standard_normal((256, 64)) * 0.06)
                              .astype(np.float32)).to(torch.bfloat16)
    router[:, 1:6] = router[:, :1]
    logits = flat @ router.to(card)
    eye = torch.eye(512, dtype=torch.bfloat16)
    out = []
    for dev in ("cpu", card):
        gates, experts = layers.route(eye.to(dev), logits.to(dev), 6)
        pos, keep = layers.capacity_slots(experts, 64, 60)
        out.append([t.cpu() for t in (gates, experts, pos, keep)])
    (g0, e0, p0, k0), (g1, e1, p1, k1) = out
    assert torch.equal(e0, e1) and torch.equal(p0, p1) and torch.equal(k0, k1)
    torch.testing.assert_close(g1, g0, rtol=0, atol=2 * 2.0 ** -23)
    assert bool((e0 < 6).any()) and not bool(k0.all())


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("S", [1, 40])
def test_mamba_mixers_on_card_match_cpu(card, name, S):
    """The Mamba1 / Mamba2 mixer of one smoke layer on the card against
    the CPU from the same weights, input and incoming state: the output
    within 4 bf16 ulps of its largest value (the bf16 projections sum in
    other orders on the two devices, so a value may round apart), and so
    are the f32 scan state and the conv inputs, which come from those
    projections."""
    from repro_torch.models import layers, model

    cfg = smoke_config(ARCHS[name])
    p = model._layer(init_params(cfg, seed=4, device="cpu")["layers"], 0)
    mix = layers.mamba1_mix if cfg.ssm == "mamba1" else layers.mamba2_mix
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    spec = model.cache_spec(cfg, 2, 64)["layers"]
    state = {k: torch.from_numpy((rng.standard_normal(leaf.shape[1:]) * 0.5)
                                 .astype(np.float32)).to(leaf.dtype)
             for k, leaf in spec.items()}
    out = []
    for dev in (card, torch.device("cpu")):
        st = {k: v.clone().to(dev) for k, v in state.items()}
        y = mix(x.to(dev), _tree_to(p, dev), cfg, state=st)
        assert st["ssm"].dtype == torch.float32
        out.append((y.float().cpu(), st["ssm"].cpu(), st["conv"].cpu()))
    (yc, hc, cc), (yp, hp, cp) = out

    def ulp(t):
        return 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 7)
    assert float((yc - yp).abs().max()) <= 4 * ulp(yp)
    assert float((hc - hp).abs().max()) <= 4 * ulp(hp)
    assert float((cc.float() - cp.float()).abs().max()) <= 4 * ulp(cp.float())


def test_hybrid_decode_on_card_matches_cpu(card):
    """A smoke zamba2 past its 64-slot window on the card against the CPU:
    a 70-token prompt through the rolling cache, then 4 steps; logits
    within a few bf16 ulps; every slot's recorded position equal; no
    decode-attention launch (the rolling cache attends in plain
    PyTorch)."""
    from repro_torch.models import model

    cfg = smoke_config(ARCHS["zamba2-7b"])
    params = init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 74)))
    out = []
    for dev in (card, torch.device("cpu")):
        p = _tree_to(params, dev)
        cache = model.init_cache(cfg, 1, 96, device=dev)
        before = build.LAUNCHES["decode_attn"]
        rows = []
        lg, cache = model.decode_step(cfg, p, {"tokens": toks[:, :70].to(dev),
                                               "cache_pos": 0}, cache)
        rows.append(lg[0, -1].float().cpu())
        for t in range(70, 74):
            lg, cache = model.decode_step(cfg, p, {
                "tokens": toks[:, t:t + 1].to(dev), "cache_pos": t}, cache)
            rows.append(lg[0, -1].float().cpu())
        assert build.LAUNCHES["decode_attn"] == before
        out.append((torch.stack(rows), cache["attn_pos"].cpu()))
    (lc, pc), (lp, pp) = out
    assert torch.equal(pc, pp)
    assert float((lc - lp).abs().max()) <= 0.05 * float(lp.abs().max())


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _train_state(cfg, dev):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init as opt_init
    from repro_torch.optim.grad_compress import init_error_feedback

    params = init_params(cfg, seed=0, device=dev)
    step, ocfg = make_train_step(cfg, grad_compression=True)
    return step, params, opt_init(ocfg, params), init_error_feedback(params)


def test_train_step_on_card_matches_cpu(card):
    """One smoke-width train step (compression on) from the same weights
    and batch on the card and on the CPU: the loss within 1e-2 and the
    grad norm within 3 % (bf16 GEMMs sum in other orders), the optimizer
    step equal, the bf16 params bit-equal on 99 % of their elements and
    every element within one bf16 ulp of itself or 2 lr of the CPU's."""
    from repro_torch.data import DataConfig, ShardedTokenStream
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    toks = torch.from_numpy(ShardedTokenStream(DataConfig(
        cfg.vocab, 64, 2)).batch_at(0)["tokens"])
    step, params, state, err = _train_state(cfg, torch.device("cpu"))
    out = []
    for dev in (card, torch.device("cpu")):
        p, s, e = (_to_dev(tree, dev) for tree in (params, state, err))
        t = toks.to(dev)
        p, s, e, m = step(p, s, e, {"tokens": t, "labels": t})
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    float(m["lr"]), int(s["step"]),
                    {k: v.detach().float().cpu()
                     for k, v in leaves_with_paths(p)}))
    (lc, nc, lr, sc, pc), (lh, nh, _, sh, ph) = out
    assert abs(lc - lh) <= 1e-2 and abs(nc - nh) <= 0.03 * nh
    assert sc == sh == 1
    n_diff = n_all = 0
    for k, a in pc.items():
        b = ph[k]
        n_diff, n_all = n_diff + int((a != b).sum()), n_all + a.numel()
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30)))
                         - 7)
        d = (a - b).abs()
        assert bool(((d <= ulp) | (d <= 2 * lr)).all()), k
    assert n_diff <= 0.01 * n_all


def _to_dev(tree, dev):
    """A copy of ``tree`` on ``dev`` (a copy on the CPU too: the train
    step writes in place)."""
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def test_checkpoint_from_the_card_restores_on_the_cpu(card, tmp_path):
    """A train state saved from the card (bf16 params and residuals, f32
    moments, the int32 step) restores on the CPU byte for byte."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    step, params, state, err = _train_state(cfg, card)
    t = torch.arange(64, device=card).reshape(2, 32) % cfg.vocab
    params, state, err, _ = step(params, state, err,
                                 {"tokens": t, "labels": t})
    tree = {"params": params, "opt": state, "err": err}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    mgr.wait()
    got, manifest = mgr.restore(tree, device="cpu")
    assert manifest["step"] == 1
    want = leaves_with_paths(tree)
    flat = leaves_with_paths(got)
    assert [k for k, _ in flat] == [k for k, _ in want]
    for (k, a), (_, b) in zip(flat, want):
        b = b.detach().cpu()
        assert a.device.type == "cpu" and a.dtype == b.dtype, k
        assert a.shape == b.shape, k
        bits = (lambda x: x.view(torch.int16)) if a.dtype == torch.bfloat16 \
            else (lambda x: x)
        assert torch.equal(bits(a), bits(b)), k


# every family the port trains, at smoke width; qwen2-0.5b also with remat
# (its full config's), whose checkpoint must capture
TRAINED = [("qwen2-0.5b", False), ("qwen2-0.5b", True),
           ("deepseek-v2-lite-16b", False), ("falcon-mamba-7b", False),
           ("zamba2-7b", False), ("hubert-xlarge", False),
           ("llava-next-34b", False)]


@pytest.fixture
def deterministic(monkeypatch):
    """Deterministic algorithms, cuBLAS's workspace config set as they
    require."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _train_batch(cfg, dev, step, seq=32):
    from repro_torch.data import DataConfig, ShardedTokenStream
    from repro_torch.launch.train import frontend_embeds

    toks = torch.from_numpy(ShardedTokenStream(DataConfig(
        cfg.vocab, seq, 2)).batch_at(step)["tokens"]).to(dev)
    batch = {"labels": toks}
    if cfg.uses_tokens:
        batch["tokens"] = toks
    else:
        batch["embeds"] = frontend_embeds(cfg, toks, 0, step)
    return batch


@pytest.mark.parametrize("name,remat", TRAINED)
def test_train_graph_replay_equals_eager_step(card, deterministic, name,
                                              remat):
    """``TrainGraph`` on the card: the first step its eager warm-up, then
    one capture and a replay at each of the next two; under deterministic
    algorithms every step's metrics and, after it, every state leaf
    (params, moments, the step counter, the residuals) equal the plain
    step run eagerly on a copy, bit for bit."""
    import dataclasses

    from repro_torch.launch.train import TrainGraph
    from repro_torch.tree import leaves_with_paths

    cfg = dataclasses.replace(smoke_config(ARCHS[name]), remat=remat)
    step, params, state, err = _train_state(cfg, card)
    eager = [_to_dev(tree, card) for tree in (params, state, err)]
    run = TrainGraph(step, params, state, err)
    for i in range(3):
        batch = _train_batch(cfg, card, i)
        got = {k: float(v) for k, v in run(batch).items()}
        *eager, m = step(*eager, batch)
        assert got == {k: float(v) for k, v in m.items()}, i
        want = dict(leaves_with_paths({"params": eager[0], "opt": eager[1],
                                       "err": eager[2]}))
        for k, t in leaves_with_paths(run.state):
            assert torch.equal(_bits(t), _bits(want[k])), (i, k)
    assert run.graph is not None and run.capture_s > 0 and run.warmup_s > 0
    assert int(run.opt_state["step"]) == 3


def test_train_checkpoint_after_replays_restores_and_recaptures(
        card, deterministic, tmp_path):
    """``train`` on the card: 3 steps (a warm-up, then a capture and two
    replays) and a checkpoint; the checkpoint restores bit-equal to the
    run's state; the resumed run captures again and its 2 steps equal
    the last 2 of 5 straight, losses and state bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves_with_paths

    kw = dict(arch="qwen2-0.5b", smoke=True, seq_len=32, global_batch=2,
              device=card, log_every=100)
    straight = train(steps=5, **kw)
    first = train(steps=3, ckpt_dir=str(tmp_path), **kw)
    assert first["capture_s"] is not None
    saved = {"params": first["params"], "opt": first["opt_state"],
             "err": first["err"]}
    restored, manifest = CheckpointManager(str(tmp_path)).restore(
        saved, device=card)
    assert manifest["step"] == 3
    want = dict(leaves_with_paths(saved))
    for k, t in leaves_with_paths(restored):
        assert torch.equal(_bits(t), _bits(want[k])), k
    resumed = train(steps=5, ckpt_dir=str(tmp_path), **kw)
    assert resumed["start_step"] == 3 and resumed["capture_s"] is not None
    assert resumed["losses"] == straight["losses"][3:]
    want = dict(leaves_with_paths({"params": straight["params"],
                                   "opt": straight["opt_state"],
                                   "err": straight["err"]}))
    for k, t in leaves_with_paths({"params": resumed["params"],
                                   "opt": resumed["opt_state"],
                                   "err": resumed["err"]}):
        assert torch.equal(_bits(t), _bits(want[k])), k


def test_train_graph_rejects_a_batch_of_another_shape(card):
    from repro_torch.launch.train import TrainGraph

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    run = TrainGraph(*_train_state(cfg, card))
    for i in range(3):
        run(_train_batch(cfg, card, i))
    assert run.graph is not None
    with pytest.raises(ValueError, match="replays only"):
        run(_train_batch(cfg, card, 2, seq=16))


def test_train_graph_capture_failure_propagates(card):
    """A step that reads a value on the host cannot be captured: after
    the eager warm-up the capture's error reaches the caller, and a
    third call raises too (the graph replays only a successful capture)
    instead of running eagerly."""
    from repro_torch.launch.train import TrainGraph

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    step, params, state, err = _train_state(cfg, card)

    def reading(*args):
        out = step(*args)
        float(out[3]["loss"])
        return out
    run = TrainGraph(reading, params, state, err)
    run(_train_batch(cfg, card, 0))
    assert run.warmup_s is not None and run.graph is None
    main = torch.cuda.current_stream(card)
    for i in (1, 2):
        with pytest.raises(RuntimeError):
            run(_train_batch(cfg, card, i))
        assert int(run.opt_state["step"]) == 1, i   # the warm-up's alone
        assert torch.cuda.current_stream(card) == main
    torch.cuda.synchronize()


def test_moe_block_ep_on_a_unit_mesh_equals_the_plain_block(card, tmp_path):
    """A world of one on the card (NCCL over a ``FileStore``), a (1, 1)
    (data, model) mesh: deepseek-v2-lite-16b's MoE at 512 channels (4
    experts, top-2) under the train cell's rules goes through
    ``moe_block_ep`` — local capacity = global capacity, the exchanges
    no-ops — and equals the plain block bit for bit, output and aux."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh, rules_for, shard_tree
    from repro_torch.launch.mesh import param_shardings
    from repro_torch.models import layers
    from repro_torch.models.sharding import use_rules

    cfg = dataclasses.replace(smoke_config(ARCHS["deepseek-v2-lite-16b"]),
                              d_model=512)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = rules_for(cfg, ShapeConfig("train", 64, 2, "train"), mesh)
        params = init_params(cfg, seed=0, device=card)
        moe = {k: (v[0] if not isinstance(v, dict) else
                   {kk: vv[0] for kk, vv in v.items()})
               for k, v in params["layers"]["moe"].items()}
        placed = shard_tree(params, param_shardings(cfg, rules))["layers"]
        pm = {k: (v[0] if not isinstance(v, dict) else
                  {kk: vv[0] for kk, vv in v.items()})
              for k, v in placed["moe"].items()}
        gen = torch.Generator(device=card).manual_seed(1)
        x = torch.randn(2, 64, 512, generator=gen, device=card).to(
            torch.bfloat16)
        want, want_aux = layers.moe_block(x, moe, cfg)
        calls, ep = [], layers.moe_block_ep
        layers.moe_block_ep = lambda *a, **kw: calls.append(1) or ep(*a, **kw)
        try:
            with use_rules(rules.act()):
                got, aux = layers.moe_block(x, pm, cfg)
        finally:
            layers.moe_block_ep = ep
        torch.cuda.synchronize()
        assert calls == [1]
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert float(aux) == float(want_aux)
    finally:
        dist.destroy_process_group()
