"""Port vs reference: continuous batching and multi-stream serving.

* the arrival processes and ``request_trace`` are array-identical to the
  reference's;
* ``SchedulerReport`` arithmetic on identical records is identical;
* on the smoke model (the reference's weights through
  ``params_from_jax``), each request's tokens equal its solo
  ``ServeEngine.generate`` under join/leave, a capacity stall, prefix
  share, the reclaim ladder and 2 shards, and the tier is empty after
  ``run()``;
* under the logical capacity model the control plane — every record's
  admit / first-token / finish step and KV charge, the peak batch and
  the step count — equals the reference scheduler's on the same trace.
  The physical model's ratio estimate and the modeled clock read the
  stored bytes, which differ by the few ulps between the frameworks' bf16
  KV, so they are held to the reference within 2 % (a KV ulp moves a
  window's compressed size by a few bytes in ~1.3 kB);
* each stream of a ``MultiStreamEngine`` decodes its solo run's tokens;
* the CLI's ``--num-requests`` and ``--streams`` modes run on the CPU.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import synth as rsynth  # noqa: E402
from repro.runtime import paging as rpaging  # noqa: E402
from repro.runtime import serving as rserving  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.core import synth as tsynth  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
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


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("share", [0, 16])
def test_request_trace_identical_to_reference(kind, share):
    kw = dict(rate=0.7, kind=kind, prompt_len=32, new_tokens=4, batch=2,
              burst=3, seed=5, share_prefix_len=share)
    got = tsynth.request_trace(7, 500, **kw)
    want = rsynth.request_trace(7, 500, **kw)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["arrival"] == w["arrival"] and g["seed"] == w["seed"]
        assert g["max_new_tokens"] == w["max_new_tokens"]
        assert g["prompt"].dtype == w["prompt"].dtype == np.int32
        np.testing.assert_array_equal(g["prompt"], w["prompt"])
    if share:
        assert all(np.array_equal(g["prompt"][:, :share],
                                  got[0]["prompt"][:, :share]) for g in got)
    np.testing.assert_array_equal(tsynth.poisson_arrivals(50, 0.5, seed=1),
                                  rsynth.poisson_arrivals(50, 0.5, seed=1))
    np.testing.assert_array_equal(
        tsynth.bursty_arrivals(50, 0.5, burst=4, seed=2),
        rsynth.bursty_arrivals(50, 0.5, burst=4, seed=2))


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_arrivals(4, rate=0.0),
    lambda m: m.bursty_arrivals(4, rate=1.0, burst=0),
    lambda m: m.request_trace(2, 128, kind="uniform"),
    lambda m: m.request_trace(2, 128, prompt_len=8, share_prefix_len=9)])
def test_trace_validation_matches_reference(call):
    for mod in (tsynth, rsynth):
        with pytest.raises(ValueError):
            call(mod)


# ---------------------------------------------------------------------------
# report arithmetic on identical records
# ---------------------------------------------------------------------------

def _records(mod, spec):
    out = []
    for i, (ttft, tpot, ntok, finished, delay) in enumerate(spec):
        r = mod.RequestRecord(req_id=i, arrival=float(i))
        r.t_arrive_s = 0.1 * i
        r.t_admit_s = r.t_arrive_s + delay
        r.t_first_token_s = r.t_arrive_s + ttft
        r.t_finish_s = r.t_first_token_s + tpot * (ntok - 1)
        r.kv_projected_bytes, r.kv_novel_bytes = 1000, 400 * (i % 2) - 1
        if finished:
            r.tokens = np.zeros((1, ntok), np.int32)
        out.append(r)
    return out


REPORT_PROPS = ("slo_attainment", "tok_s", "p50_latency_s", "p99_latency_s",
                "mean_queue_delay_s", "p50_ttft_s", "p99_ttft_s",
                "mean_tpot_s")


@pytest.mark.parametrize("spec,slo", [
    ([], {}),
    ([(0.1, 0.01, 4, True, 0.0)], {}),
    ([(0.1, 0.01, 4, False, 0.0)], {"slo_ttft_s": 1.0}),
    ([(0.10, 0.01, 4, True, 0.0), (0.90, 0.01, 4, True, 0.3),
      (0.10, 0.20, 4, True, 0.05), (0.3, 0.0, 1, True, 0.2)],
     {"slo_ttft_s": 0.5, "slo_tpot_s": 0.05}),
    ([(0.10, 0.01, 4, True, 0.0), (0.90, 0.01, 3, True, 0.3),
      (0.4, 0.0, 1, True, 0.1)], {"slo_ttft_s": 0.5}),
    ([(0.1, 0.0, 1, True, 0.0)], {"slo_ttft_s": 0.5, "slo_tpot_s": 1e-9}),
])
def test_report_arithmetic_identical(spec, slo):
    reps = [mod.SchedulerReport(records=_records(mod, spec), steps=7,
                                model_time_s=0.25, decode_tokens=9,
                                prefill_tokens=3, **slo)
            for mod in (tserving, rserving)]
    for name in REPORT_PROPS:
        a, b = (getattr(r, name) for r in reps)
        assert (np.isnan(a) and np.isnan(b)) or a == b, name
    for q in (0, 37.5, 90):
        for fn in ("latency_percentile", "ttft_percentile"):
            a, b = (getattr(r, fn)(q) for r in reps)
            assert (np.isnan(a) and np.isnan(b)) or a == b
    for ta, tb in zip(reps[0].records, reps[1].records):
        for name in ("finished", "kv_charged_bytes", "queue_delay_s",
                     "latency_s", "ttft_s", "tpot_s"):
            a, b = getattr(ta, name), getattr(tb, name)
            assert (a != a and b != b) or a == b, name


def test_capacity_model_and_ladder_validated():
    with pytest.raises(ValueError):
        tserving.ServeScheduler(None, None, capacity_model="psychic")
    with pytest.raises(ValueError, match="physical"):
        tserving.ServeScheduler(None, None,
                                degrade_ladder=tpaging.DEFAULT_DEGRADE_LADDER)


# ---------------------------------------------------------------------------
# model-backed scheduler runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(smoke_model):
    rcfg, rparams = smoke_model("qwen2-0.5b")
    tcfg = smoke_config(ARCHS["qwen2-0.5b"])
    tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return rcfg, rparams, tcfg, tparams


SCHED = dict(device_kind="trace", page_tokens=16, hbm_kv_budget=1 << 12)


def _tsched(cfg, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("policy", tpaging.LOSSLESS_POLICY)
    return tserving.ServeScheduler(cfg, params, device="cpu", **SCHED, **kw)


def _reqs(mod, vocab, n, arrivals, prompt_len=32, new=5):
    rng = np.random.default_rng(11)
    return [mod.ServeRequest(
        req_id=i, arrival=float(arrivals[i]),
        prompt=rng.integers(0, vocab, (1, prompt_len)).astype(np.int32),
        max_new_tokens=new, seed=100 + i) for i in range(n)]


def _solo(cfg, params, sched, req):
    return tserving.ServeEngine(
        cfg, params, max_seq=sched.max_seq, batch=1, page_tokens=16,
        hbm_kv_budget=1 << 12, device_kind="trace", policy=sched.policy,
        importance=sched.importance, device="cpu",
    ).generate(req.prompt, req.max_new_tokens, seed=req.seed)


def _assert_tier_empty(sched):
    stores = getattr(sched.tier, "shards", [sched.tier])
    assert sched.tier.resident_bytes() == 0
    for dev in stores:
        assert dev.stats.dram_bytes_stored == dev.stats.raw_bytes_stored == 0
        assert dev.stats.blocks == 0
        assert not dev._tensors and not dev._kv_staging and not dev._ledger
    assert sched.kv_committed_bytes == 0
    assert all(s is None for s in sched.active) and not sched.pending


@pytest.mark.parametrize("case", ["join-leave", "stall", "share",
                                  "share-attention", "ladder", "2-shards"])
def test_scheduler_tokens_equal_solo_runs(models, case):
    _, _, cfg, params = models
    proj = tserving.projected_kv_bytes(cfg, 1, 32 + 5, 16)
    arrivals = [0.0, 0.5, 1.0, 6.0, 6.0]
    kw = {"join-leave": dict(kv_capacity_bytes=2 * proj),
          "stall": dict(kv_capacity_bytes=int(1.5 * proj)),
          "share": dict(kv_capacity_bytes=int(1.5 * proj),
                        prefix_share=True),
          "share-attention": dict(kv_capacity_bytes=int(1.5 * proj),
                                  prefix_share=True, importance="attention",
                                  policy=tpaging.PAPER_POLICY),
          "ladder": dict(kv_capacity_bytes=int(1.5 * proj),
                         capacity_model="physical",
                         policy=tpaging.PAPER_POLICY,
                         degrade_ladder=tpaging.DEFAULT_DEGRADE_LADDER),
          "2-shards": dict(kv_capacity_bytes=2 * proj, shards=2,
                           prefix_share=True)}[case]
    reqs = _reqs(tserving, cfg.vocab, 5, arrivals)
    if kw.get("prefix_share"):
        for r in reqs[1:]:                    # share two page windows
            r.prompt[:, :32] = reqs[0].prompt[:, :32]
    sched = _tsched(cfg, params, **kw)
    rep = sched.run(reqs)
    assert len(rep.records) == 5
    assert any(r.admit_step > int(np.ceil(r.arrival)) for r in rep.records)
    for req, rec in zip(reqs, rep.records):
        np.testing.assert_array_equal(_solo(cfg, params, sched, req),
                                      rec.tokens)
    if case == "stall":
        assert rep.peak_active == 1 and rep.records[1].queue_delay_s > 0
    if kw.get("prefix_share"):
        assert any(r.kv_charged_bytes < r.kv_projected_bytes
                   for r in rep.records)
    if case == "ladder":
        assert rep.reclaimed_bytes > 0
    if case == "2-shards":
        assert rep.n_devices == 2
    _assert_tier_empty(sched)


def test_ladder_on_4_shards_equals_one_tier(models):
    """The reclaim ladder on a 4-shard fleet frees exactly the bytes it
    frees on one tier (stored bytes are per key) and keeps the tokens."""
    _, _, cfg, params = models
    proj = tserving.projected_kv_bytes(cfg, 1, 32 + 5, 16)
    reps = []
    for shards in (1, 4):
        sched = _tsched(cfg, params, kv_capacity_bytes=int(1.5 * proj),
                        capacity_model="physical", max_batch=3,
                        policy=tpaging.PAPER_POLICY, shards=shards,
                        placement="hash-stripe",
                        degrade_ladder=tpaging.DEFAULT_DEGRADE_LADDER)
        reps.append(sched.run(_reqs(tserving, cfg.vocab, 4,
                                    [0.0, 0.0, 1.0, 2.0])))
        _assert_tier_empty(sched)
    one, four = reps
    assert one.reclaimed_bytes == four.reclaimed_bytes > 0
    assert _control_plane(one)[:3] == _control_plane(four)[:3]
    assert one.kv_ratio_estimate == four.kv_ratio_estimate
    for a, b in zip(one.records, four.records):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert four.n_devices == 4


def _control_plane(rep):
    return ([(r.req_id, r.admit_step, r.first_token_step, r.finish_step,
              r.kv_projected_bytes, r.kv_novel_bytes, r.prefill_tokens)
             for r in rep.records],
            rep.steps, rep.peak_active, rep.decode_tokens,
            rep.prefill_tokens, rep.n_devices, rep.capacity_model)


@pytest.mark.parametrize("share,shards,kind", [
    (False, 1, "poisson"), (True, 1, "bursty"), (True, 2, "poisson")])
def test_logical_control_plane_identical_to_reference(models, share, shards,
                                                      kind):
    rcfg, rparams, tcfg, tparams = models
    kw = dict(max_batch=3, page_tokens=16, hbm_kv_budget=1 << 12,
              kv_capacity_bytes=int(1.5 * tserving.projected_kv_bytes(
                  tcfg, 1, 48 + 5, 16)),
              capacity_model="logical", prefix_share=share, shards=shards)
    trace = dict(rate=0.5, kind=kind, prompt_len=48, new_tokens=5, seed=3,
                 share_prefix_len=32)
    t = tserving.ServeScheduler(tcfg, tparams, device="cpu",
                                policy=tpaging.PAPER_POLICY, **kw)
    r = rserving.ServeScheduler(rcfg, rparams, policy=rpaging.PAPER_POLICY,
                                **kw)
    trep = t.run(tsynth.request_trace(6, tcfg.vocab, **trace))
    rrep = r.run(rsynth.request_trace(6, rcfg.vocab, **trace))
    assert _control_plane(trep) == _control_plane(rrep)
    assert trep.peak_active >= (2 if share else 1)
    assert any(r.queue_delay_s > 0 for r in trep.records)
    if share:
        assert any(r.kv_novel_bytes < r.kv_projected_bytes
                   for r in trep.records)
    _assert_tier_empty(t)


def test_physical_model_tracks_reference(models):
    rcfg, rparams, tcfg, tparams = models
    proj = tserving.projected_kv_bytes(tcfg, 1, 32 + 5, 16)
    kw = dict(max_batch=3, page_tokens=16, hbm_kv_budget=1 << 12,
              kv_capacity_bytes=int(1.7 * proj), capacity_model="physical")
    t = tserving.ServeScheduler(tcfg, tparams, device="cpu",
                                policy=tpaging.LOSSLESS_POLICY, **kw)
    r = rserving.ServeScheduler(rcfg, rparams,
                                policy=rpaging.LOSSLESS_POLICY, **kw)
    arrivals = [0.0, 0.0, 0.0]
    trep = t.run(_reqs(tserving, tcfg.vocab, 3, arrivals))
    rrep = r.run(_reqs(rserving, rcfg.vocab, 3, arrivals))
    assert trep.peak_active == rrep.peak_active > 1
    assert trep.kv_ratio_estimate == pytest.approx(rrep.kv_ratio_estimate,
                                                   rel=0.02)
    assert trep.model_time_s == pytest.approx(rrep.model_time_s, rel=0.02)
    assert trep.reclaimed_bytes == 0
    _assert_tier_empty(t)


def test_idle_ticks_and_single_token_request(models):
    _, _, cfg, params = models
    sched = _tsched(cfg, params)
    sched.submit(_reqs(tserving, cfg.vocab, 1, [4.7], new=1))
    for _ in range(4):                        # nothing has arrived yet
        assert sched.step() and sched.n_active == 0
    assert sched.clock == 4 and sched.model_time_s > 0
    rep = sched.run()
    r = rep.records[0]
    assert r.admit_step == 5 and r.queue_delay_s == 0.0
    assert np.isnan(r.tpot_s) and r.ttft_s == pytest.approx(r.latency_s)
    assert np.isnan(rep.mean_tpot_s)
    _assert_tier_empty(sched)


# ---------------------------------------------------------------------------
# multi-stream engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_multistream_streams_equal_solo_runs(models, shards):
    _, _, cfg, params = models
    n_streams, n_tok = 3, 6
    prompts = [((np.arange(48) * (i + 1) + i) % cfg.vocab)
               .astype(np.int32).reshape(1, 48) for i in range(n_streams)]
    kw = dict(max_seq=96, batch=1, page_tokens=16, hbm_kv_budget=1 << 12,
              policy=tpaging.PAPER_POLICY)
    multi = tserving.MultiStreamEngine(cfg, params, n_streams,
                                       device_kind="trace", shards=shards,
                                       device="cpu", **kw)
    toks = multi.generate(prompts, n_tok)
    for i in range(n_streams):
        solo = tserving.ServeEngine(cfg, params, device_kind="trace",
                                    key_prefix=f"s{i}.", device="cpu", **kw)
        np.testing.assert_array_equal(
            toks[i], solo.generate(prompts[i], n_tok, seed=i))
    d = multi.device_stats()
    summed = {f: sum(getattr(t, f) for eng in multi.streams
                     for t in eng.pool.page_traffic.values())
              for f in ("dram_bytes_read", "dram_bytes_written",
                        "link_bytes_in", "link_bytes_out", "index_bytes")}
    assert summed == {f: getattr(d, f) for f in summed}
    keys = [k for eng in multi.streams for k in eng.pool.page_traffic]
    assert len(keys) == len(set(keys))
    assert multi.throughput_ceiling() > 0
    assert sum(s.tier_io_queue_delay_s for s in multi.stats()) > 0
    assert multi.retire() > 0 and multi.tier.resident_bytes() == 0


# ---------------------------------------------------------------------------
# the CLI at smoke width on the CPU
# ---------------------------------------------------------------------------

def _cli(monkeypatch, capsys, *args):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--cpu", *args])
    tlaunch.main()
    return capsys.readouterr().out


def test_cli_continuous_batching(monkeypatch, capsys):
    out = _cli(monkeypatch, capsys, "--num-requests", "4",
               "--arrival-rate", "0.5", "--prompt-len", "192", "--tokens",
               "4", "--hbm-kv-budget", "16384", "--max-batch", "3",
               "--prefix-share", "--share-prefix-len", "128",
               "--kv-capacity", "100000", "--capacity-model", "physical",
               "--degrade-ladder", "default", "--sanitize")
    assert "continuous batching: 4 requests" in out
    assert "prefix share: admission charged" in out
    assert "admission ratio estimate" in out
    assert "tier after retirement: stored 0 B, 0 blocks" in out


def test_cli_streams(monkeypatch, capsys):
    out = _cli(monkeypatch, capsys, "--streams", "2", "--requests", "1",
               "--prompt-len", "64", "--tokens", "4",
               "--hbm-kv-budget", "16384")
    assert "1 requests x 2 streams x 1 x (64 prompt + 4 new)" in out
    assert "generated tok/s" in out


def test_cli_ladder_needs_physical_model(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--cpu",
                                      "--num-requests", "2",
                                      "--degrade-ladder", "man4,man0"])
    with pytest.raises(SystemExit, match="physical"):
        tlaunch.main()
    assert tlaunch.parse_degrade_ladder("default") == \
        tpaging.DEFAULT_DEGRADE_LADDER
    assert tlaunch.parse_degrade_ladder("none") == ()
    with pytest.raises(SystemExit):
        tlaunch.parse_degrade_ladder("man3")


def test_new_entry_points_default_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, cfg, params = models
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.ServeScheduler(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.MultiStreamEngine(cfg, params, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.serve_continuous(smoke=True, num_requests=1)
