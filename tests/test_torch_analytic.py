"""Port vs reference: the analytic models and the synthetic generators.

* the reference's eight ``test_system_model.py`` tests, on the port's
  ``system_model`` / ``controller`` / ``dram_model``, with the
  reference's own tolerances;
* every model function equal to the reference's (``==`` on floats: the
  same numpy operations in the same order): the throughput model over
  designs, contexts, alphas, formats and elastic bits; the DRAM model
  over units, targets, designs and level sets; the controller for every
  design x ``meta_hit`` x ``bypass``; ``PPA_TABLE``;
* ``synth.kv_cache`` / ``weights`` (bf16, fp8, int4) / ``quantized_bits``
  array-identical to the reference, the numpy BF16 / FP8 casts identical
  to ``ml_dtypes`` on every bf16 pattern (fp8 past 240, subnormals, inf,
  NaN) and on random float32 / float64 values.
"""

import dataclasses
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import controller as rctl  # noqa: E402
from repro.core import dram_model as rdram  # noqa: E402
from repro.core import synth as rsynth  # noqa: E402
from repro.core import system_model as rsys  # noqa: E402
from repro_torch.core import controller as tctl  # noqa: E402
from repro_torch.core import dram_model as tdram  # noqa: E402
from repro_torch.core import synth as tsynth  # noqa: E402
from repro_torch.core import system_model as tsys  # noqa: E402
from repro_torch.core.controller import load_to_use_cycles  # noqa: E402
from repro_torch.core.dram_model import (  # noqa: E402
    EXPERT, HEAD, NEURON, energy_per_weight_pj, mixture_for_target,
)
from repro_torch.core.system_model import (  # noqa: E402
    PAPER_ANCHORS_FIG12, gpt_oss_120b, sweep_alpha, throughput,
)


# ---------------------------------------------------------------------------
# the reference's test_system_model.py, on the port
# ---------------------------------------------------------------------------

def test_fig12_anchors_within_tolerance():
    """Mean relative error over the 8 published Fig-12 points < 15 %."""
    m = gpt_oss_120b("mxfp4")
    errs = []
    for design, anchors in PAPER_ANCHORS_FIG12.items():
        for ctx, want in anchors.items():
            got = throughput(m, ctx, design).tok_s
            errs.append(abs(got - want) / want)
    assert float(np.mean(errs)) < 0.15, errs


def test_gcomp_useless_on_kv_bound_regime():
    m = gpt_oss_120b("mxfp4")
    p = throughput(m, 131072, "plain").tok_s
    g = throughput(m, 131072, "gcomp").tok_s
    assert g / p < 1.1


def test_trace_dominates_all_contexts():
    m = gpt_oss_120b("bf16")
    for ctx in (4096, 65536, 131072, 262144):
        t = throughput(m, ctx, "trace", alpha=0.8).tok_s
        p = throughput(m, ctx, "plain", alpha=0.8).tok_s
        assert t >= p


def test_alpha_sweep_unimodal_and_trace_peak_higher():
    m = gpt_oss_120b("bf16")
    alphas = list(np.linspace(0.1, 0.95, 18))
    sw = sweep_alpha(m, 131072, alphas)
    for design, ys in sw.items():
        arr = np.round(np.array(ys), 9)
        d = np.sign(np.diff(arr))
        d = d[d != 0]
        assert np.sum(np.abs(np.diff(d))) <= 2, design
    assert max(sw["trace"]) > max(sw["gcomp"]) > max(sw["plain"])


def test_controller_anchor_cycles():
    assert load_to_use_cycles("plain") == 71
    assert load_to_use_cycles("gcomp") == 84
    assert load_to_use_cycles("trace") == 89
    assert load_to_use_cycles("trace", comp_ratio=3.0) == 85
    assert load_to_use_cycles("trace", bypass=True) == 76
    assert load_to_use_cycles("trace", meta_hit=False) > 89


def test_mixture_hits_target_mean():
    for target in (1.6, 4.8, 8.0, 12.0):
        mix = mixture_for_target(target)
        mean = sum(b * f for b, f in mix.items())
        assert mean == pytest.approx(target, rel=0.02)


def test_plane_fetch_beats_word_fetch_everywhere():
    for unit in (EXPERT, HEAD, NEURON):
        for bits in (1.6, 4.8, 8.0):
            e_p = energy_per_weight_pj(unit, bits, "plain")
            e_t = energy_per_weight_pj(unit, bits, "trace")
            assert e_t < e_p, (unit.name, bits)


def test_neuron_savings_below_head_savings():
    for bits in (4.8, 8.0):
        s_head = 1 - (energy_per_weight_pj(HEAD, bits, "trace")
                      / energy_per_weight_pj(HEAD, bits, "plain"))
        s_neu = 1 - (energy_per_weight_pj(NEURON, bits, "trace")
                     / energy_per_weight_pj(NEURON, bits, "plain"))
        assert s_neu < s_head + 1e-9


# ---------------------------------------------------------------------------
# every model function equal to the reference's
# ---------------------------------------------------------------------------

DESIGNS = ("plain", "gcomp", "trace")


@pytest.mark.parametrize("fmt", ["mxfp4", "bf16"])
def test_throughput_model_equals_reference(fmt):
    tm, rm = tsys.gpt_oss_120b(fmt, batch=3), rsys.gpt_oss_120b(fmt, batch=3)
    assert dataclasses.asdict(tm) == dataclasses.asdict(rm)
    ctxs = (4096, 65536, 131072, 196608, 262144)
    for design in DESIGNS:
        for wf in ("bf16", "mxfp4"):
            assert dataclasses.asdict(tsys.DesignRatios.for_design(
                design, wf)) == dataclasses.asdict(
                rsys.DesignRatios.for_design(design, wf))
        for ctx in ctxs:
            for alpha in (None, 0.3, 0.8):
                for bits in (None, 4.0, 6.0):
                    got = tsys.throughput(tm, ctx, design, alpha=alpha,
                                          elastic_spill_bits=bits)
                    want = rsys.throughput(rm, ctx, design, alpha=alpha,
                                           elastic_spill_bits=bits)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)
        sys_kw = dict(hbm_bytes=40e9, cxl_link_bw=256e9, f_rd=0.5)
        got = tsys.throughput(tm, 65536, design,
                              sys=tsys.SystemSpec(**sys_kw),
                              ratios=tsys.DesignRatios(1.3, 2.0))
        want = rsys.throughput(rm, 65536, design,
                               sys=rsys.SystemSpec(**sys_kw),
                               ratios=rsys.DesignRatios(1.3, 2.0))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    alphas = list(np.linspace(0.1, 0.95, 7))
    assert tsys.sweep_alpha(tm, 131072, alphas) == \
        rsys.sweep_alpha(rm, 131072, alphas)
    assert tsys.sweep_context(tm, ctxs) == rsys.sweep_context(rm, ctxs)
    assert dataclasses.asdict(tsys.SystemSpec()) == \
        dataclasses.asdict(rsys.SystemSpec())
    assert tsys.PAPER_ANCHORS_FIG12 == rsys.PAPER_ANCHORS_FIG12
    assert tsys.PAPER_ANCHORS_FIG13 == rsys.PAPER_ANCHORS_FIG13


def test_dram_model_equals_reference():
    for name in ("ROW_BYTES", "BURST_BYTES", "E_BYTE_PJ", "E_ACT_PJ",
                 "ROW_HIT_PLANE_STREAM", "ROW_HIT_WORD_MIXED"):
        assert getattr(tdram, name) == getattr(rdram, name), name
    units = [(getattr(tdram, u), getattr(rdram, u))
             for u in ("HEAD", "NEURON", "EXPERT")]
    for tu, ru in units:
        assert dataclasses.asdict(tu) == dataclasses.asdict(ru)
    for levels in ((1, 2, 4, 8, 16), (2, 4, 8, 16), (2, 4, 8), (2, 4)):
        for target in (0.5, 1.6, 3.0, 4.8, 8.0, 12.0, 16.0, 20.0):
            assert tdram.mixture_for_target(target, levels) == \
                rdram.mixture_for_target(target, levels)
            for (tu, ru) in units:
                for design in ("plain", "trace"):
                    assert tdram.energy_split_per_weight_pj(
                        tu, target, design, levels=levels) == \
                        rdram.energy_split_per_weight_pj(
                            ru, target, design, levels=levels)
                    assert tdram.energy_per_weight_pj(
                        tu, target, design, levels=levels) == \
                        rdram.energy_per_weight_pj(ru, target, design,
                                                   levels=levels)
    for (tu, ru) in units:
        for design in ("plain", "trace"):
            for bits in (1.6, 8.0):
                assert tdram.model_load_energy_j(96, tu, bits, design) == \
                    rdram.model_load_energy_j(96, ru, bits, design)
                assert tdram.load_latency_s(96, tu, bits, design,
                                            ddr_bw=128e9) == \
                    rdram.load_latency_s(96, ru, bits, design, ddr_bw=128e9)


def test_controller_and_ppa_equal_reference():
    for design in DESIGNS:
        for ratio in (0.5, 1.0, 1.5, 2.2, 3.0):
            for meta_hit in (True, False):
                for bypass in (True, False):
                    kw = dict(comp_ratio=ratio, meta_hit=meta_hit,
                              bypass=bypass)
                    assert tctl.load_to_use_cycles(design, **kw) == \
                        rctl.load_to_use_cycles(design, **kw)
                    assert tctl.load_to_use_ns(design, **kw) == \
                        rctl.load_to_use_ns(design, **kw)
    assert tctl.BYPASS_BURST == rctl.BYPASS_BURST
    assert tctl.INDEX_MISS_BURST == rctl.INDEX_MISS_BURST
    assert tctl.STAGES == rctl.STAGES
    assert tctl.PPA_TABLE.keys() == rctl.PPA_TABLE.keys()
    for k, v in rctl.PPA_TABLE.items():
        assert dataclasses.asdict(tctl.PPA_TABLE[k]) == dataclasses.asdict(v)
    for args in ((64, 128), (128, 256, 1, 32, 4), (1, 1, 2, 0, 3)):
        assert tctl.staging_sram_bytes(*args) == \
            rctl.staging_sram_bytes(*args)
    # the link model prices receipts exactly as before
    from repro.core.tier import LinkModel as RLink
    from repro_torch.core.tier import LinkModel as TLink

    for design in DESIGNS:
        for ratio in (1.0, 1.5, 3.0):
            assert TLink.for_design(design, comp_ratio=ratio).base_s == \
                RLink.for_design(design, comp_ratio=ratio).base_s


# ---------------------------------------------------------------------------
# synthetic generators and the casts behind them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((512, 256), 0), ((16, 64), 7),
                                        ((33, 5), 3)])
def test_kv_cache_identical_to_reference(shape, seed):
    got = tsynth.kv_cache(*shape, seed=seed)
    want = rsynth.kv_cache(*shape, seed=seed)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    kw = dict(smooth=0.5, scale_spread=3.0, outlier_frac=0.2, mean_snr=0.1)
    np.testing.assert_array_equal(tsynth.kv_cache(*shape, seed=seed, **kw),
                                  rsynth.kv_cache(*shape, seed=seed, **kw))


@pytest.mark.parametrize("fmt", ["bf16", "fp8", "int4"])
@pytest.mark.parametrize("n,seed", [(6_000, 0), (4096 * 3, 5), (77, 2)])
def test_weights_and_quantized_bits_identical_to_reference(fmt, n, seed):
    got = tsynth.weights(n, fmt, seed=seed)
    want = rsynth.weights(n, fmt, seed=seed)
    np.testing.assert_array_equal(got, want)
    wide = dict(row=64, scale_spread=2.0)
    np.testing.assert_array_equal(tsynth.weights(n, fmt, seed=seed, **wide),
                                  rsynth.weights(n, fmt, seed=seed, **wide))
    if fmt != "bf16":
        np.testing.assert_array_equal(tsynth.quantized_bits(want, fmt),
                                      rsynth.quantized_bits(want, fmt))
    with pytest.raises(ValueError):
        tsynth.quantized_bits(want, "bf16")


def _all_bf16_values() -> np.ndarray:
    return np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)


def test_fp8_codes_identical_on_every_bf16_pattern():
    """Every bf16 value through ``quantized_bits(fp8)``: past 240 (to inf
    from 248), the subnormals down to 2^-9 and their halfway ties, inf
    and NaN of either sign."""
    u = _all_bf16_values()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = rsynth.quantized_bits(u, "fp8")
    np.testing.assert_array_equal(tsynth.quantized_bits(u, "fp8"), want)
    finite = u[(u & 0x7F80) != 0x7F80]
    np.testing.assert_array_equal(tsynth.quantized_bits(finite, "int4"),
                                  rsynth.quantized_bits(finite, "int4"))
    edge = np.array([240, 247, 248, 250, 256, 1e4, -300, 2 ** -9, 2 ** -10,
                     3 * 2 ** -11, 2 ** -11, 0.0, -0.0], dtype=np.float32)
    codes = tsynth.to_fp8_e4m3_bits(edge)
    assert codes.tolist() == [0x77, 0x77, 0x78, 0x78, 0x78, 0x78, 0xF8, 1,
                              0, 1, 0, 0, 0x80]


def test_casts_identical_to_ml_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(11)
    f32 = rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    scaled = (rng.standard_normal(1 << 18)
              * np.exp2(rng.integers(-20, 12, 1 << 18))).astype(np.float32)
    f64 = rng.standard_normal(1 << 16) * np.exp2(
        rng.integers(-140, 128, 1 << 16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for x in (f32, scaled):
            np.testing.assert_array_equal(
                tsynth.to_bf16_bits(x),
                x.astype(ml_dtypes.bfloat16).view(np.uint16))
            np.testing.assert_array_equal(
                tsynth.to_fp8_e4m3_bits(x),
                x.astype(ml_dtypes.float8_e4m3).view(np.uint8))
        np.testing.assert_array_equal(
            tsynth.to_bf16_bits(f64),
            f64.astype(ml_dtypes.bfloat16).view(np.uint16))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tsynth.fp8_e4m3_to_f32(codes).view(np.uint32),
        codes.view(ml_dtypes.float8_e4m3).astype(np.float32).view(np.uint32))
    u = _all_bf16_values()
    np.testing.assert_array_equal(
        tsynth.bf16_bits_to_f32(u).view(np.uint32),
        u.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


def test_port_generators_do_not_need_ml_dtypes():
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "src"
    code = ("import sys; sys.modules['ml_dtypes'] = None\n"
            "from repro_torch.core import synth\n"
            "from repro_torch.runtime import weights\n"
            "print(synth.weights(64, 'fp8').sum())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(src)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == int(rsynth.weights(64, "fp8").astype(
        np.int64).sum())
