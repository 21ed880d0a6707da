"""The harness is driven by data: cells, configurations, traffic mixes,
limits and metrics are found by name, a new one is a new file, the same
seed gives the same requests, and the readers compute what they say on
synthetic runs and traces."""

import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import devtrace, harness, readers, registry, traffic  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy(tmp_path):
    """The benchmark's files in a fresh checkout-like directory."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    return tmp_path, tmp_path / "portbench"


def test_benchmark_file_is_whole():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for g in ("end_to_end", "per_layer")
             for m in bench[g]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (registry.PKG / "metrics" / f"{m['name']}.py").exists()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        entry = registry.workload(bench, w["name"])
        assert (registry.PKG / "traffic" / f"{entry['traffic']}.json").exists()
        assert (registry.PKG / "limits" / f"{w['name']}.json").exists()
        registry.config(bench, entry["config"])
        shown = registry.cell_metrics(bench, w["name"], False)
        assert "setup_s" in {m["name"] for m in shown} and len(shown) >= 2
        assert registry.cell_metrics(bench, w["name"], True)
        for m in registry.cell_metrics(bench, w["name"], True):
            moved = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
            assert "workloads" not in moved[0] or \
                w["name"] in moved[0]["workloads"], (w["name"], m["name"])


def test_program_section_matches_the_published_keys():
    bench = registry.benchmark()
    for c in bench["configs"]:
        conf = registry.config(bench, c["name"])
        prog = conf["program"]
        assert prog["d_model"] == conf["hidden_size"]
        assert prog["n_layers"] == conf["num_hidden_layers"]
        assert prog["n_heads"] == conf["num_attention_heads"]
        assert prog["n_kv_heads"] == conf["num_key_value_heads"]
        assert prog["vocab"] == conf["vocab_size"]
        assert prog["d_ff"] == conf["intermediate_size"]
        assert prog["rope_theta"] == conf["rope_theta"]
        if conf.get("n_routed_experts"):
            assert (prog["n_experts"], prog["top_k"], prog["moe_d_ff"],
                    prog["n_shared_experts"], prog["first_dense"],
                    prog["kv_lora_rank"], prog["qk_rope_dim"],
                    prog["v_head_dim"], prog["head_dim"],
                    prog["capacity_factor"]) == (
                conf["n_routed_experts"], conf["num_experts_per_tok"],
                conf["moe_intermediate_size"], conf["n_shared_experts"],
                conf["first_k_dense_replace"], conf["kv_lora_rank"],
                conf["qk_rope_head_dim"], conf["v_head_dim"],
                conf["qk_nope_head_dim"], conf["capacity_factor"])
        for key in c["reduced"]:
            assert conf["published"][key] != conf[key]


def test_new_files_are_found_by_name(tmp_path):
    root, pkg = _copy(tmp_path)
    bench = registry.load_json(root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    conf = registry.config(bench, "qwen2-0.5b", root)
    (pkg / "configs" / "qwen2-0.5b-wide.json").write_text(
        json.dumps(dict(conf, hidden_size=1024)))
    spec = registry.traffic("kv_spill_256", pkg)
    (pkg / "traffic" / "short_burst.json").write_text(
        json.dumps(dict(spec, new_tokens=16)))
    (pkg / "metrics" / "tokens_total.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "qwen2-0.5b-wide", "source": "x",
                             "file": "portbench/configs/qwen2-0.5b-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "qwen2-0.5b-wide.short_burst",
                               "config": "qwen2-0.5b-wide",
                               "traffic": "short_burst", "chips": 1,
                               "why": "x"})
    w = registry.workload(bench, "qwen2-0.5b-wide.short_burst")
    assert registry.config(bench, w["config"], root)["hidden_size"] == 1024
    assert registry.traffic(w["traffic"], pkg)["new_tokens"] == 16
    assert registry.metric_reader("tokens_total", pkg).read(None) == 42.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_same_seed_same_requests():
    """The same seed gives the same requests; every seed the same lengths
    in the same order (the same work), another seed other tokens."""
    spec = registry.traffic("kv_spill_256")
    a, b = traffic.schedule(spec), traffic.schedule(spec)
    assert a == b
    assert np.array_equal(a[1][0].prompt(2147483701, 8, 151936),
                          b[1][0].prompt(2147483701, 8, 151936))
    assert not np.array_equal(a[1][0].prompt(2147483701, 8, 151936),
                              a[1][0].prompt(2147483702, 8, 151936))
    lens = traffic.lengths(spec)
    assert 2 * len(a) == spec["requests"]
    assert [r.prompt_len for r in a[0]] == [lens[0], lens[-1]]
    assert {sum(r.prompt_len for r in pair) for pair in a} == \
        {lens[0] + lens[-1]}
    assert [r.index for pair in a for r in pair] == \
        list(range(spec["requests"]))
    # the first pairs span the range: each halves the widest gap left
    first = [pair[0].prompt_len for pair in a[:5]]
    assert first == [512, 768, 640, 576, 704]
    w = traffic.warmup(spec)
    assert w.prompt_len == lens[-1] and w.new_tokens == spec["page_tokens"] + 2


@pytest.mark.parametrize("n", [1, 2, 5, 17, 33])
def test_spread_orders_every_index_once(n):
    order = traffic.spread(n)
    assert sorted(order) == list(range(n)) and order[:2] == [0, n - 1][:n]


def _run(requests, window=(0, 10_000_000_000), **kw):
    base = dict(conf=registry.config(registry.benchmark(), "qwen2-0.5b"),
                traffic={"page_tokens": 4}, window=window,
                requests=requests, setup_s=3.5, peak_bytes=3 << 30,
                spans={}, tier_bytes=dict(write_raw=0, write_stored=0,
                                          read_stored=0, read_decoded=0))
    base.update(kw)
    return harness.Run(**base)


def _req(index, due, times, prompt_len=8, new_tokens=4, batch=2, **kw):
    r = harness.RequestLog(index, prompt_len, new_tokens, batch, due=due,
                           prefill_start=due + 10_000_000, times=list(times))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_readers_on_a_synthetic_run():
    ms = 1_000_000
    r0 = _req(0, 0, [100 * ms, 110 * ms, 120 * ms, 190 * ms, 200 * ms],
              pages_committed=10, pages_spilled=4)
    r1 = _req(1, 300 * ms, [400 * ms, 405 * ms, 20_000 * ms],
              pages_committed=6, pages_spilled=0)
    run = _run([r0, r1], window=(0, 1000 * ms))
    # tokens: 4 of r0 and 2 of r1 in the window, 2 sequences each
    assert readers.out_tok_s(run) == pytest.approx(12 / 1.0)
    assert readers.ttft_mean_ms(run) == pytest.approx(100.0)
    gaps = [10, 10, 70, 5]
    assert sorted(readers.itl_gaps_ms(run)) == sorted(gaps)
    assert readers.itl_p99_ms(run) == pytest.approx(np.percentile(gaps, 99))
    assert readers.prefill_ms(run) == pytest.approx(90.0)
    # prompt 8, page 4: no served token's step completes a window
    assert readers.boundary_gap_ms(run) is None
    assert readers.spill_share(run) == pytest.approx(25.0)
    assert registry.metric_reader("peak_mem_gib").read(run) == 3.0
    assert registry.metric_reader("setup_s").read(run) == 3.5


def test_boundary_gap_and_spans():
    ms = 1_000_000
    r = _req(0, 0, [10 * ms, 20 * ms, 30 * ms, 80 * ms, 90 * ms],
             prompt_len=5, new_tokens=5)
    run = _run([r], spans={"capture": [(15 * ms, 19 * ms), (2000 * ms,
                                                           2001 * ms)],
                           "tier write": [(1 * ms, 3 * ms)]},
               tier_bytes=dict(write_raw=2 << 20, write_stored=1 << 20,
                               read_stored=0, read_decoded=0),
               window=(0, 1000 * ms))
    # prompt 5: step 3 ends the window at position 8 (page 4)
    assert readers.boundary_gap_ms(run) == pytest.approx(50.0)
    assert readers.capture_s(run) == pytest.approx(0.004)
    assert readers.tier_write_ms_per_mib(run) == pytest.approx(1.0)
    assert readers.tier_read_ms_per_mib(run) is None


def test_mfu_counts_prefill_and_decode_steps_in_the_window():
    from portbench import counts

    ms = 1_000_000
    r = _req(0, 0, [10 * ms, 20 * ms, 30 * ms, 2000 * ms], prompt_len=8,
             new_tokens=3, batch=2)
    run = _run([r], window=(0, 1000 * ms))
    conf = run.conf
    want = (counts.prefill_flops(conf, 2, 8) + counts.decode_flops(conf, 2, 8)
            + counts.decode_flops(conf, 2, 9))
    assert readers.mfu(run) == pytest.approx(
        100 * want / (1.0 * counts.BF16_FLOPS_S))


def _events():
    # two kernels of a graph replay, a tier kernel, a copy, a marker each
    # end; trace clock = host clock + 1000
    ev = devtrace.Events(
        names=["spin_kernel", "gemm", "gemm", "pack", "Memcpy HtoD",
               "spin_kernel"],
        start=np.array([1000, 2000, 2600, 5000, 5500, 9000]),
        end=np.array([1100, 2500, 3000, 5200, 5900, 9100]),
        corr=np.array([1, 2, 2, 3, 4, 5]),
        runtime={1: ("cudaLaunchKernel", 1000), 2: ("cudaGraphLaunch", 1900),
                 3: ("cudaLaunchKernel", 4900), 4: ("cudaMemcpyAsync", 5400),
                 5: ("cudaLaunchKernel", 9000)})
    clock = devtrace.Clock()
    clock.marks, clock.est = [0, 8000], 900
    return ev, clock


def test_trace_summary():
    ev, clock = _events()
    t = devtrace.summarise(ev, clock, (0, 9000),
                           {"tier write": [(3800, 4000)]},
                           {"tier write": [(3800, 4000)],
                            "decode step": [(800, 3500)]})
    assert t.marker_offsets_ns == [1000, 1000]
    assert t.window_s == pytest.approx(9000e-9)
    # busy: [1000,1100] [2000,2500] [2600,3000] [5000,5200] [5500,5900]
    # [9000,9100]
    # clipped to [1000, 10000]
    assert t.busy_s == pytest.approx(1700e-9)
    assert t.replays == 1 and t.replay_kernel_s == pytest.approx(900e-9)
    assert t.span_kernel_s["tier write"] == pytest.approx(200e-9)
    assert t.top_ops[0] == ["gemm", pytest.approx(900e-9)]
    idle = dict(t.idle_by_host)
    # gaps [2500,2600] and [3000,5000] lie under the decode step, which the
    # clock puts at [1800,4500]
    assert idle["decode step"] == pytest.approx(2100e-9)
    assert sum(idle.values()) == pytest.approx(9000e-9 - 1700e-9)


def test_merge_unions_overlaps():
    s, e = devtrace.merge(np.array([5, 0, 2, 10]), np.array([7, 3, 4, 11]))
    assert s.tolist() == [0, 5, 10] and e.tolist() == [4, 7, 11]
