"""Port on a mesh: the pipelined prefill against the port's ``forward``
and the reference's ``make_pp_prefill_step`` on the same mesh, and a
serve step under the decode cell's rules against the single-rank decode.

Pipeline: stablelm-12b at smoke width with 4 layers (the reference's
``test_pipeline.py`` setup), the port's seed-0 params, (4, 16) tokens,
on gloo ranks at (stage, data, model) (2, 1, 1), (4, 1, 1) and (2, 2, 1)
with ``n_micro`` 2 (and 4 where the local batch splits 4 ways): every
rank returns the same logits, within 3e-2 of the port's single-rank
``forward``; ``n_micro`` 2 vs 4 within 1e-3.  Against the reference's
pipelined prefill on the same mesh of host devices (one subprocess,
``tests/torch_mesh_ref.py``): within 3e-2 plus, element by element, the
two frameworks' own ``forward`` difference on these params (up to 0.05:
bf16 rounds at other places in the two graphs; the reference holds its
pipeline to its forward within 3e-2, so the port's pipeline, equal to
its forward, is this far from the reference's).

Serve step: qwen2-0.5b at smoke width on (data, model) (1, 2), params
and the KV cache placed by the decode cell's rules (the cache's sequence
over ``model``, 16 of 32 slots a rank), a 16-token prompt then 4 single
tokens of 2 sequences: the logits against the single-rank decode of the
same tokens within the margin-aware bound of
``tests/test_kv_dtype.py::test_fp8_cache_decode_tracks_bf16``.  Each
layer's cache is gathered whole over ``model`` for its attention (the
decode kernel's plain version on the CPU) and this rank's slots written
back, so the logits are in fact the single rank's bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_cases import (  # noqa: E402
    PP_B, PP_S, SERVE_B, SERVE_MAX, SERVE_PROMPT, SERVE_STEPS,
    finish_reference, pipeline_case, pp_config, run_world, serve_case,
    start_reference, stop_reference, to_np,
)

pytestmark = pytest.mark.slow   # model-forward module

PP_MESHES = {(2, 1, 1): (2, (2, 4)), (4, 1, 1): (4, (2, 4)),
             (2, 2, 1): (4, (2,))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.model import decode_step, forward, init_cache
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves_with_paths

    tmp = tmp_path_factory.mktemp("mesh_pp")
    cfg = pp_config()
    params = init_params(cfg, seed=0, device="cpu")
    pnp = {k: to_np(v) for k, v in leaves_with_paths(params)}
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (PP_B, PP_S)
                                             ).astype(np.int32)
    job = [{"kind": "pipeline", "name": "x".join(map(str, s)), "mesh": list(s),
            "layers": cfg.n_layers, "n_micro": 2, "forward": i == 0}
           for i, s in enumerate(PP_MESHES)]
    ref = start_reference(job, {"pp_tokens": toks, **{f"pp/{k}": v for k, v
                                                      in pnp.items()}}, tmp)
    try:
        fwd = forward(cfg, params, {"tokens": torch.from_numpy(toks)})[0]
        pp = {s: run_world(pipeline_case, n, tmp / ("w" + "x".join(map(str, s))),
                           s, micros, pnp, toks)[0]
              for s, (n, micros) in PP_MESHES.items()}

        qcfg = smoke_config(ARCHS["qwen2-0.5b"])
        stoks = np.random.default_rng(2).integers(
            0, qcfg.vocab, (SERVE_B, SERVE_PROMPT + SERVE_STEPS)).astype(np.int32)
        served = run_world(serve_case, 2, tmp / "serve", (1, 2), stoks)[0]
        qparams = init_params(qcfg, seed=0, device="cpu")
        cache = init_cache(qcfg, SERVE_B, SERVE_MAX, device="cpu")
        t = torch.from_numpy(stoks)
        logits, _ = decode_step(qcfg, qparams, {"tokens": t[:, :SERVE_PROMPT],
                                                "cache_pos": 0}, cache)
        seq = [logits[:, -1]]
        for i in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS):
            logits, _ = decode_step(qcfg, qparams, {"tokens": t[:, i : i + 1],
                                                    "cache_pos": i}, cache)
            seq.append(logits[:, 0])
        return {"forward": fwd.float().numpy(), "pp": pp,
                "ref": finish_reference(ref), "served": served,
                "decoded": torch.stack(seq, 1).float().numpy()}
    finally:
        stop_reference(ref)


@pytest.mark.parametrize("shape", list(PP_MESHES),
                         ids=["x".join(map(str, s)) for s in PP_MESHES])
def test_pipelined_prefill_matches_forward_and_reference(runs, shape):
    got = runs["pp"][shape][2]
    assert got["same"]
    np.testing.assert_allclose(got["logits"], runs["forward"], rtol=3e-2,
                               atol=3e-2)
    ref = runs["ref"]
    want = ref["x".join(map(str, shape)) + "/logits"]
    noise = np.abs(runs["forward"] - ref["forward/logits"])
    assert (np.abs(got["logits"] - want) <= 3e-2 + noise).all()


@pytest.mark.parametrize("shape", [(2, 1, 1), (4, 1, 1)], ids=["2x1x1",
                                                               "4x1x1"])
def test_pipelined_prefill_microbatch_count_invariance(runs, shape):
    a, b = runs["pp"][shape][2], runs["pp"][shape][4]
    assert b["same"]
    np.testing.assert_allclose(a["logits"], b["logits"], rtol=1e-3,
                               atol=1e-3)


def test_serve_step_under_decode_rules_tracks_single_rank(runs):
    served = runs["served"]
    assert served["placements"] == [("Shard", 1), ("Shard", 2)]
    assert served["local_seq"] == SERVE_MAX // 2
    ref, got = runs["decoded"], served["logits"]
    agree = ref.argmax(-1) == got.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    rms = float(np.sqrt(np.mean((ref - got) ** 2)))
    assert rms < 0.5 * float(np.median(margin)), (rms, np.median(margin))
    assert agree[margin > 4.0 * rms].all()
    assert agree.mean() > 0.8
