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
    bitplane, build, decode_attn, lz4, pnm_score,
)
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.runtime import LOSSLESS_POLICY, ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

ATOL, RTOL = 2e-5, 1e-5      # f32 summation order (decode attention)


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


@pytest.mark.parametrize("n", [8, 16, 8000, 131072])
def test_pack_kernel_matches_plain(card, n):
    x = _kv_bits(n, n).to(card)
    before = build.LAUNCHES["bitplane_pack"]
    assert torch.equal(bitplane.pack_planes_u16(x),
                       bitplane.pack_planes_plain(x))
    assert build.LAUNCHES["bitplane_pack"] == before + 1


@pytest.mark.parametrize("n", [1, 5, 1000, 262144])
def test_prep_kernel_matches_plain(card, n):
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.integers(0, 3, n, dtype=np.uint8)).to(card)
    for got, want in zip(lz4.lz4_prep(buf), lz4.prep_plain(buf)):
        assert torch.equal(got, want)


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


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("B,H,KV,hd,S,valid", [
    (1, 14, 2, 64, 640, 576), (2, 14, 2, 64, 200, 200),
    (2, 8, 2, 32, 256, 37), (1, 4, 4, 128, 96, 1), (3, 16, 1, 64, 33, 33),
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


def _scores_equal(a, b):
    """Bitwise equal, NaN matching NaN (payloads may differ)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("P,T,C", [(64, 64, 128), (24, 64, 128), (5, 16, 64),
                                   (3, 7, 40), (2, 3, 1024), (1, 1, 1)])
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
    recs = {}
    for dev in (card, "cpu"):
        t = tier.make_device("trace", device=dev)
        recs[str(dev)] = t.submit(
            [tier.WriteReq(f"p{i}", p, kind=tier.KV) for i, p in enumerate(pages)]
        ) + t.submit([tier.ReadReq(f"p{i}", kind=tier.KV, view=v)
                      for i in range(20) for v in (precision.FULL,
                                                   precision.MAN0)])
    for a, b in zip(recs[str(card)], recs["cpu"], strict=True):
        assert {k: v for k, v in vars(a).items() if k != "data"} == \
            {k: v for k, v in vars(b).items() if k != "data"}
        if b.data is not None:
            np.testing.assert_array_equal(a.data, b.data)


def test_engine_on_card_runs_every_kernel(card):
    """Classic readback and the PNM path (attention importance, 2 shards)
    on the card: together they launch every kernel."""
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
    assert all(build.LAUNCHES[name] > 0 for name in build.SOURCES), \
        build.LAUNCHES
