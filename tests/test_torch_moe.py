"""Port vs reference: MoE routing and the MoE block, exactly.

The same normalised tokens ``h`` reach both routers.  The reference runs
op by op (``jax.disable_jit``), so every op rounds as its source says
(its router logits are bf16 before the f32 softmax); under jit XLA's CPU
compiler keeps some of those products in f32, which the model-level
tests of ``tests/test_torch_arch.py`` bound instead.

Held exactly: the expert indices and the ``keep`` mask (which (token,
choice) pairs the capacity drops); the gates to f32 rounding (2 f32
ulps of 1); the block's bf16 output within 1 bf16 ulp of each token's
largest value, with at most 1 % of the elements off at all (the expert
matmuls sum in another order in the two frameworks).  Cases: (a)
capacity factor 1.0, where the reference drops tokens; (b) a router whose duplicated columns give
tied probabilities, where the lower expert index must win; (c) the
single-token dense-decode path.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as rlayers  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

GATE_TOL = 2 * 2.0 ** -23
B = 2


@pytest.fixture(scope="module")
def moe_layers(smoke_model):
    """Per arch: (reference cfg, reference MoE params of the last stacked
    layer, port cfg, the same params carried across)."""
    out = {}
    for name in ("deepseek-v2-lite-16b", "grok-1-314b"):
        rcfg, rparams = smoke_model(name)
        tcfg = smoke_config(ARCHS[name])
        tparams = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, rparams),
                                     device="cpu")
        out[name] = (rcfg, jax.tree.map(lambda a: a[-1],
                                        rparams["layers"]["moe"]),
                     tcfg, tm._layer(tparams["layers"], -1)["moe"])
    return out


def _run_both(rcfg, rp, tcfg, tp, x):
    """Both packages' routing on the same normalised tokens and both
    blocks' outputs on the same ``x``."""
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    E, k = tcfg.n_experts, tcfg.top_k
    T = x.shape[0] * x.shape[1]
    cap = int(max(1, tcfg.capacity_factor * k * T / E))
    with jax.disable_jit():
        h = rlayers.norm(xj, rp["norm"], rcfg.norm).reshape(T, -1)
        _, _, _, keep, gates, experts, _ = rlayers._local_dispatch(
            h, rcfg, cap, rp["router"])
        out, _ = rlayers.moe_block(xj, rp, rcfg)
    ht = tlayers.norm(xt, tp["norm"], tcfg.norm).reshape(T, -1)
    assert np.array_equal(ht.float().numpy(), np.asarray(h, np.float32))
    tg, te = tlayers.route(ht, tp["router"], k)
    _, tkeep = tlayers.capacity_slots(te, E, cap)
    return (dict(experts=np.asarray(experts), gates=np.asarray(gates),
                 keep=np.asarray(keep), out=np.asarray(out, np.float32)),
            dict(experts=te.numpy(), gates=tg.numpy(), keep=tkeep.numpy(),
                 out=tlayers.moe_block(xt, tp, tcfg)[0].float().numpy()))


def _assert_out_close(got, want):
    """Within 1 bf16 ulp of each token's largest value, at most 1 % of
    the elements off."""
    top = np.abs(want).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() <= 0.01


def _assert_same(want, got):
    np.testing.assert_array_equal(got["experts"], want["experts"])
    np.testing.assert_array_equal(got["keep"], want["keep"])
    np.testing.assert_allclose(got["gates"], want["gates"], rtol=0,
                               atol=GATE_TOL)
    _assert_out_close(got["out"], want["out"])


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "grok-1-314b"])
@pytest.mark.parametrize("capacity", [4.0, 1.0])
def test_routing_and_capacity_drops_equal_reference(moe_layers, name,
                                                    capacity):
    """(a) At capacity factor 1.0 the reference drops (token, choice)
    pairs in its cumsum order, and the port drops the same ones; at the
    smoke factor 4.0 nothing drops."""
    rcfg, rp, tcfg, tp = moe_layers[name]
    rcfg = dataclasses.replace(rcfg, capacity_factor=capacity)
    tcfg = dataclasses.replace(tcfg, capacity_factor=capacity)
    x = np.random.default_rng(7).standard_normal(
        (B, 40, tcfg.d_model)).astype(np.float32)
    want, got = _run_both(rcfg, rp, tcfg, tp, x)
    _assert_same(want, got)
    dropped = int((~want["keep"]).sum())
    assert dropped > 0 if capacity == 1.0 else dropped == 0


def test_tied_router_picks_the_lower_expert(moe_layers):
    """(b) Experts 0, 1 and 2 share one router column, so their
    probabilities tie exactly; with k = 2 a token whose top experts are
    those three must take 0 and 1, as ``jax.lax.top_k`` does."""
    rcfg, rp, tcfg, tp = moe_layers["deepseek-v2-lite-16b"]
    router = np.asarray(rp["router"]).copy()
    router[:, 1] = router[:, 2] = router[:, 0]
    rp = dict(rp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(
        router.view(np.int16).copy()).view(torch.bfloat16))
    x = np.random.default_rng(3).standard_normal(
        (B, 40, tcfg.d_model)).astype(np.float32)
    want, got = _run_both(rcfg, rp, tcfg, tp, x)
    _assert_same(want, got)
    tied = (want["experts"] < 3).all(-1)
    assert tied.any() and (np.sort(want["experts"][tied], -1)
                           == [0, 1]).all()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_single_token_dense_decode_equals_reference(moe_layers, name):
    """(c) S == 1: every expert runs on the token, masked by the f32
    scatter-add of the gates; the capacity path would drop at this
    factor, the dense path never does."""
    rcfg, rp, tcfg, tp = moe_layers[name]
    rcfg = dataclasses.replace(rcfg, capacity_factor=1.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0)
    x = np.random.default_rng(5).standard_normal(
        (B, 1, tcfg.d_model)).astype(np.float32)
    want, got = _run_both(rcfg, rp, tcfg, tp, x)
    np.testing.assert_array_equal(got["experts"], want["experts"])
    np.testing.assert_allclose(got["gates"], want["gates"], rtol=0,
                               atol=GATE_TOL)
    _assert_out_close(got["out"], want["out"])


def test_capacity_slots_follow_row_major_cumsum():
    """Slots count each expert's (token, choice) pairs in row-major
    order; pairs at or past the capacity are dropped."""
    experts = torch.tensor([[0, 1], [1, 0], [0, 2], [0, 1]])
    pos, keep = tlayers.capacity_slots(experts, 3, 2)
    assert pos.tolist() == [[0, 0], [1, 1], [2, 0], [3, 2]]
    assert keep.tolist() == [[True, True], [True, True], [False, True],
                             [False, False]]
