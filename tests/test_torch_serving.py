"""Port vs reference: the paged KV pool and the serving engine.

* pools fed the *same* pages give byte-identical tier bytes, receipts and
  readback;
* ``ServeEngine`` with the reference's weights tracks the reference
  engine: teacher-forced logits within the margin-aware bound of
  ``tests/test_kv_dtype.py`` (bf16 rounds at other places in the two
  frameworks), equal spilled-page counts and equal logical bytes stored;
* async readback matches sync under a lossless policy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import synth  # noqa: E402
from repro.runtime import KVPagePool as RPool  # noqa: E402
from repro.runtime import ServeEngine as RServe  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.runtime import KVPagePool as TPool  # noqa: E402
from repro_torch.runtime import ServeEngine as TServe  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

ENGINE = dict(max_seq=96, batch=1, page_tokens=16, hbm_kv_budget=1 << 12)


@pytest.fixture(scope="module")
def models(smoke_model):
    rcfg, rparams = smoke_model("qwen2-0.5b")
    tcfg = smoke_config(ARCHS["qwen2-0.5b"])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.mark.parametrize("policy", ["paper", "lossless"])
def test_pools_fed_same_pages_identical(policy):
    pols = {"paper": (tpaging.PAPER_POLICY, rpaging.PAPER_POLICY),
            "lossless": (tpaging.LOSSLESS_POLICY, rpaging.LOSSLESS_POLICY)}
    kv = synth.kv_cache(16 * 12, 64, seed=3)
    tpool = TPool("trace", 16, 6 * 16 * 64 * 2, pols[policy][0],
                  key_prefix="s0.", device="cpu")
    rpool = RPool("trace", 16, 6 * 16 * 64 * 2, pols[policy][1],
                  key_prefix="s0.")
    outs = []
    for pool in (tpool, rpool):
        spilled = []
        for b in range(4):              # four commit boundaries
            pages = [(layer, kind, 48 * b + 16 * i,
                      kv[48 * b + 16 * i: 48 * b + 16 * (i + 1)],
                      float(48 * b + 16 * i))
                     for i in range(3) for layer in (0, 1) for kind in "kv"]
            pool.append_pages(pages)
            events, pool.spill_events = pool.spill_events, []
            spilled.append(([p.key for p in events], pool.read_pages(events)))
        outs.append((spilled, pool.read_layer(1, "v")))
    for (tk, td), (rk, rd) in zip(outs[0][0], outs[1][0]):
        assert tk == rk
        for a, b in zip(td, rd, strict=True):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    tdev, rdev = tpool.tier, rpool.device
    assert tdev._tensors.keys() == rdev._tensors.keys()
    for key in rdev._tensors:
        assert [b.payloads for b in tdev._tensors[key]] == \
            [b.payloads for b in rdev._tensors[key]]
    assert tpool.page_traffic.keys() == rpool.page_traffic.keys()
    for key, t in tpool.page_traffic.items():
        assert vars(t) == vars(rpool.page_traffic[key])
    assert (tpool.io_service_s, tpool.io_queue_delay_s) == \
        (rpool.io_service_s, rpool.io_queue_delay_s)
    assert tpool.spilled_pages == rpool.spilled_pages > 0
    assert tpool.release() == rpool.release()
    assert tdev.resident_bytes() == rdev.resident_bytes() == 0


def _teacher_forced(eng, tokens, n_prompt):
    logits = [eng.prefill(tokens[:, :n_prompt])]
    for t in range(n_prompt, tokens.shape[1]):
        logits.append(eng.decode(tokens[:, t : t + 1]))
    return np.stack([np.asarray(x, np.float32) for x in logits], 1)


@pytest.mark.parametrize("policy", ["paper", "lossless"])
def test_engine_tracks_reference_engine(models, policy):
    rcfg, rparams, tcfg, tparams = models
    tpol, rpol = {"paper": (tpaging.PAPER_POLICY, rpaging.PAPER_POLICY),
                  "lossless": (tpaging.LOSSLESS_POLICY,
                               rpaging.LOSSLESS_POLICY)}[policy]
    teng = TServe(tcfg, tparams, policy=tpol, device="cpu", **ENGINE)
    reng = RServe(rcfg, rparams, policy=rpol, **ENGINE)
    toks = (np.arange(60, dtype=np.int32).reshape(1, 60) * 7) % tcfg.vocab
    got = _teacher_forced(teng, toks, 48)
    ref = _teacher_forced(reng, toks, 48)
    ts, rs = teng.stats(), reng.stats()
    assert ts.spilled_pages == rs.spilled_pages > 0
    assert ts.kv_logical_bytes == rs.kv_logical_bytes
    assert teng.pool.stats().raw_bytes_stored == \
        reng.pool.stats().raw_bytes_stored
    assert ts.tier_dram_read > 0
    # margin-aware token bound (tests/test_kv_dtype.py)
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    assert rms < 0.5 * float(np.median(margin)), (rms, np.median(margin))
    assert agree[margin > 4.0 * rms].all()
    assert agree.mean() > 0.8
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99
    # free-running generation stays in vocab and retires cleanly
    eng = TServe(tcfg, tparams, policy=tpol, device="cpu", key_prefix="g.",
                 **ENGINE)
    gen = eng.generate(toks[:, :48], 8)
    assert gen.shape == (1, 8) and 0 <= gen.min() and gen.max() < tcfg.vocab
    assert eng.retire() > 0 and eng.pool.tier.resident_bytes("g") == 0


def test_async_matches_sync_lossless(models):
    _, _, tcfg, tparams = models
    prompt = (np.arange(48, dtype=np.int32).reshape(1, 48) * 5) % tcfg.vocab
    runs = []
    for async_io in (False, True):
        eng = TServe(tcfg, tparams, policy=tpaging.LOSSLESS_POLICY,
                     async_io=async_io, device="cpu", **ENGINE)
        runs.append((eng.generate(prompt, 12), eng.stats()))
    (t_sync, s_sync), (t_async, s_async) = runs
    np.testing.assert_array_equal(t_sync, t_async)
    assert (s_sync.tier_dram_read, s_sync.tier_link_out,
            s_sync.tier_dram_stored) == (s_async.tier_dram_read,
                                         s_async.tier_link_out,
                                         s_async.tier_dram_stored)
    assert s_async.tier_io_service_s > 0


def test_serve_entry_point_on_cpu(capsys):
    rep = serve(smoke=True, prompt_len=48, n_tokens=6, requests=2,
                hbm_kv_budget=1 << 13, page_tokens=16, torch_device="cpu")
    assert rep.spilled_pages > 0 and rep.readback_pages > 0
    assert rep.kv_compression_ratio > 1.0
    assert [t.shape for t in rep.tokens] == [(1, 6), (1, 6)]
    assert "generated tok/s" in capsys.readouterr().out


def test_cuda_engine_without_card_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, tcfg, tparams = models
    with pytest.raises(RuntimeError, match="CUDA"):
        TServe(tcfg, tparams, device="cuda", **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TServe(tcfg, tparams, **ENGINE)          # the card is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        TPool("trace")
