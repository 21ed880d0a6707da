"""Port vs reference: the expert-parallel MoE on gloo ranks.

deepseek-v2-lite-16b at smoke width (4 experts, top-2, 2 x 32 per rank
...), one MoE layer from the port's seeded draw, x (4, 16, d) bf16 from
a seeded numpy draw.  The port runs ``moe_block`` under the train cell's
rules on 2 or 4 gloo ranks at meshes (data, model) (1, 2), (2, 2) and
(1, 4), parameters sharded by the rules; the reference runs its
``moe_block`` (which takes its ``shard_map`` EP path) under the same
rules on the same mesh of host devices, in one subprocess for the
module (``tests/torch_mesh_ref.py``).  Capacity factors: the smoke 4.0,
where nothing drops, and 0.5, where the local capacity drops tokens —
the EP's drops differ from the plain block's, so the port is held to
the reference's EP at the same mesh, not to its plain block.  One more
case at (2, 2) keeps 3 of the 4 experts, which do not divide ``model``:
both take the plain path over the global batch's tokens (the port
gathers them over ``data``), held the same way.

Bounds: the output within the reference's own 2e-2 (``test_moe_ep.py``);
aux within 1e-4 relative; each token slice's keep mask equal to the
reference's ``_local_dispatch`` op by op (the port routes exactly as it
does, ``test_torch_moe.py``); the gradients of router, w1 and w2 of
``sum(out**2) + 0.01 * aux`` within 5 % relative L2 of the port's own
f32 run on the same mesh and within 0.03 + r of the reference's, ``r``
the reference's distance from that f32 gradient (``test_torch_train.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_cases import (  # noqa: E402
    EP_B, EP_S, finish_reference, moe_ep_case, run_world, start_reference,
    stop_reference, to_np,
)

pytestmark = pytest.mark.slow   # model-forward module

MESHES = {(1, 2): 2, (2, 2): 4, (1, 4): 4}
CAPACITIES = (4.0, 0.5)
PLAIN = (0.5, 3)             # capacity factor, experts: not EP at model 2


def _cases(shape):
    return [(c, 4) for c in CAPACITIES] + ([PLAIN] if shape == (2, 2) else [])
F32_RTOL, REF_RTOL = 0.05, 0.03


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.model import init_params

    tmp = tmp_path_factory.mktemp("mesh_moe")
    cfg = smoke_config(ARCHS["deepseek-v2-lite-16b"])
    moe = init_params(cfg, seed=0, device="cpu")["layers"]["moe"]
    params = {}
    for k, v in moe.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            params[k if kk is None else f"{k}/{kk}"] = to_np(vv[0])
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (EP_B, EP_S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    x = to_np(x)
    job = [{"kind": "moe_ep", "name": f"{s}/{c}/{e}", "mesh": list(s),
            "capacity": c, "experts": e} for s in MESHES for c, e in _cases(s)]
    ref = start_reference(job, {"moe_x": x, **{f"moe/{k}": v for k, v in
                                               params.items()}}, tmp)
    try:
        port = {s: run_world(moe_ep_case, n, tmp / f"w{n}_{s[0]}", s,
                             _cases(s), params, x)[0]
                for s, n in MESHES.items()}
        return port, finish_reference(ref)
    finally:
        stop_reference(ref)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


CASES = [(s, c, e) for s in MESHES for c, e in _cases(s)]
IDS = [f"{s[0]}x{s[1]}-cf{c}-e{e}" for s, c, e in CASES]


@pytest.mark.parametrize("shape,capacity,experts", CASES, ids=IDS)
def test_ep_output_and_aux_match_reference(results, shape, capacity,
                                           experts):
    port, ref = results
    got, key = port[shape][(capacity, experts)], f"{shape}/{capacity}/{experts}"
    # the bf16 and the f32 run each take the EP path where it applies
    assert got["ep_calls"] == (2 if (capacity, experts) != PLAIN else 0)
    np.testing.assert_allclose(got["out"], ref[f"{key}/out"], rtol=2e-2,
                               atol=2e-2)
    raux = float(ref[f"{key}/aux"])
    assert abs(got["aux"] - raux) <= 1e-4 * abs(raux)


@pytest.mark.parametrize("shape,capacity,experts", CASES, ids=IDS)
def test_ep_keep_mask_matches_reference(results, shape, capacity, experts):
    """Each rank's token slice drops the (token, choice) pairs the
    reference's local dispatch drops (the plain path: the whole batch's,
    on every rank); at factor 0.5 some drop, at 4.0 none."""
    port, ref = results
    key = f"{shape}/{capacity}/{experts}"
    got, want = port[shape][(capacity, experts)]["keep"], ref[f"{key}/keep"]
    if (capacity, experts) == PLAIN:
        got = got[:1]                  # every rank routed the same tokens
        assert (port[shape][PLAIN]["keep"] == got).all()
    np.testing.assert_array_equal(got, want)
    assert (~want).any() if capacity < 1 else want.all()


@pytest.mark.parametrize("shape,capacity,experts", CASES, ids=IDS)
def test_ep_grads_match_reference(results, shape, capacity, experts):
    port, ref = results
    got = port[shape][(capacity, experts)]
    for k in ("router", "w1", "w2"):
        g, g32 = got[f"grad_{k}"], got[f"grad_{k}32"]
        want = ref[f"{shape}/{capacity}/{experts}/grad_{k}"]
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        assert _rel(g, g32) <= F32_RTOL, k
        assert _rel(g, want) <= REF_RTOL + _rel(want, g32), k
