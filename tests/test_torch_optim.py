"""Port vs reference: AdamW and int8 gradient compression.

The unit tests of ``tests/test_optim.py`` on the port, then the port's
``update`` against the reference's jitted one from the same numpy
gradients, state and params, and ``compress_grads`` against the
reference's.

Tolerances (the two frameworks sum a leaf's squares in other orders, and
XLA's CPU compiler contracts ``b * m + (1 - b) * g`` into fused
multiply-adds):
* ``grad_norm`` within 4e-6 relative; ``lr`` within ``2**-21`` of the
  peak rate (the cosine comes from another libm, a few f32 ulps of 1
  apart, and ``1 + cos`` near the end of the cosine keeps them);
* f32 moments within 1e-5 of each leaf's largest magnitude (measured
  ≤ 1e-6); bf16 moments bit-equal but for at most 1 % of a leaf's
  elements (or one) and
  within 1 bf16 ulp of each leaf's largest magnitude (a value at a
  rounding boundary may round either way, and the moment carries the
  difference into later steps: measured 1 element of 6144 off, by up to
  3 ulps of its own magnitude);
* the bf16 params bit-equal but for at most 1 % of a leaf's elements
  (or one), and within 1 bf16 ulp there (measured: all bit-equal);
* ``compress_grads``: the dequantised gradients and the bf16 residual
  bit-equal to the reference's jitted graph (the port forms the
  residual's product and difference in f64 and rounds once, as the
  fused multiply-add XLA emits does); ``quantize``'s int8 codes and
  scale bit-equal to the reference's ``_quantize`` run op by op (alone
  under jit, XLA may compute ``max / 127`` as a product with the
  reciprocal, an f32 ulp apart).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamWConfig as RConfig  # noqa: E402
from repro.optim import global_norm as rglobal_norm  # noqa: E402
from repro.optim import init as rinit  # noqa: E402
from repro.optim import update as rupdate  # noqa: E402
from repro.optim.adamw import schedule as rschedule  # noqa: E402
from repro.optim import grad_compress as rgc  # noqa: E402
from repro_torch.optim import AdamWConfig, global_norm  # noqa: E402
from repro_torch.optim import init as opt_init  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.optim import update as opt_update  # noqa: E402
from repro_torch.optim.grad_compress import (  # noqa: E402
    compress_grads, compressed_bytes, init_error_feedback, quantize,
)

SHAPES = {"a": (64, 96), "b": {"c": (96,), "d": (3, 16, 32)}, "e": (7, 5)}


def _params():
    return {"w": torch.ones((8, 8)), "b": torch.zeros((8,))}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _bf16(a) -> "torch.Tensor":
    """A numpy (ml_dtypes) bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _to_torch(a):
    a = np.asarray(a)
    return _bf16(a) if a.dtype == jnp.bfloat16 else torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[x.itemsize])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), 1e-30)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# tests/test_optim.py on the port
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.05, warmup_steps=1, total_steps=200,
                      weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt_init(cfg, params)
    for _ in range(60):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad((w ** 2).sum(), [w])
        params, state, _ = opt_update(cfg, {"w": g}, state, params)
    assert float((params["w"] ** 2).sum()) < 0.2


def test_adamw_low_precision_moments():
    cfg = AdamWConfig(moment_dtype=torch.bfloat16)
    params = _params()
    state = opt_init(cfg, params)
    assert state["mu"]["w"].dtype == torch.bfloat16
    g = {k: torch.ones_like(v) for k, v in params.items()}
    _, state, _ = opt_update(cfg, g, state, params)
    assert state["nu"]["w"].dtype == torch.bfloat16
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1


def test_grad_clip_metric():
    cfg = AdamWConfig(clip_norm=1e-3)
    params = _params()
    before = params["w"].clone()
    state = opt_init(cfg, params)
    g = {k: 100.0 * torch.ones_like(v) for k, v in params.items()}
    new_params, _, m = opt_update(cfg, g, state, params)
    assert float(m["grad_norm"]) > 100
    assert float((new_params["w"] - before).abs().max()) < 0.1


def test_error_feedback_preserves_signal():
    """The residual is carried, not lost: the sum of the dequantised
    grads over steps converges to the sum of the true grads."""
    params = {"w": torch.zeros(64)}
    err = init_error_feedback(params)
    rng = np.random.default_rng(0)
    true_sum, deq_sum = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(0, 1e-4, 64).astype(np.float32))}
        true_sum += g["w"].numpy()
        deq, err = compress_grads(g, err)
        deq_sum += deq["w"].double().numpy()
    resid = err["w"].double().abs().numpy()
    np.testing.assert_allclose(deq_sum, true_sum, atol=resid.max() + 1e-5)


def test_compressed_bytes_quarter_of_f32():
    params = _params()
    f32 = sum(p.numel() * 4 for p in params.values())
    assert compressed_bytes(params) < f32 / 3


def test_update_writes_in_place():
    """``update`` writes the params and moments into the tensors it was
    given (no second copy of the train state) and returns them."""
    cfg = AdamWConfig(lr=0.1, warmup_steps=1)
    params = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    state = opt_init(cfg, params)
    w, mu = params["w"], state["mu"]["w"]
    before = w.clone()
    new_p, new_s, _ = opt_update(cfg, {"w": torch.ones_like(w)}, state,
                                 params)
    assert new_p["w"] is w and new_s["mu"]["w"] is mu
    assert not torch.equal(w, before) and float(mu.abs().max()) > 0


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    """Warmup, cosine and the floor past ``total_steps``."""
    rc = RConfig(warmup_steps=5, total_steps=20)
    tc = AdamWConfig(warmup_steps=5, total_steps=20)
    steps = np.arange(0, 26, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: rschedule(rc, s))(jnp.asarray(steps)))
    got = schedule(tc, torch.from_numpy(steps)).numpy()
    assert (np.abs(got - want) <= rc.lr * 2.0 ** -21).all()
    assert (got[:11] == want[:11]).all()      # warmup and the cosine's top
    assert got[0] == 0 and got[5] == np.float32(3e-4)


def test_global_norm_sums_leaves_in_sorted_key_order():
    """The reference sums the leaves in ``jax.tree.leaves`` order (sorted
    keys); the port's f32 sum of per-leaf sums follows it bit for bit."""
    rng = np.random.default_rng(1)
    tree = _tree(lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16))
    order = [tree["a"], tree["b"]["c"], tree["b"]["d"], tree["e"]]
    sq = order[0].float().square().sum()
    for x in order[1:]:
        sq = sq + x.float().square().sum()
    assert torch.equal(global_norm(tree), torch.sqrt(sq))
    want = float(jax.jit(rglobal_norm)(jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), tree)))
    assert abs(float(global_norm(tree)) - want) <= 4e-6 * want


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_matches_reference(moments):
    """Ten steps through warmup (3), cosine (to 8) and the floor, the
    gradients alternating between clipped (norm ~45) and unclipped
    (~4.4): bounds as the module docstring states."""
    rc = RConfig(warmup_steps=3, total_steps=8,
                 moment_dtype=getattr(jnp, moments))
    tc = AdamWConfig(warmup_steps=3, total_steps=8,
                     moment_dtype=getattr(torch, moments))
    rng = np.random.default_rng(0)
    rp = _tree(lambda s: jnp.asarray(rng.standard_normal(s), jnp.bfloat16))
    tp = jax.tree.map(_to_torch, rp)
    rs, ts = rinit(rc, rp), opt_init(tc, tp)
    rstep = jax.jit(lambda g, s, p: rupdate(rc, g, s, p))
    for step in range(10):
        scale = 0.5 if step % 2 else 0.05
        g = _tree(lambda s: jnp.asarray(rng.standard_normal(s) * scale,
                                        jnp.bfloat16))
        rp, rs, rm = rstep(g, rs, rp)
        tp, ts, tm = opt_update(tc, jax.tree.map(_to_torch, g), ts, tp)
        want_n, got_n = float(rm["grad_norm"]), float(tm["grad_norm"])
        assert abs(got_n - want_n) <= 4e-6 * want_n
        assert abs(float(tm["lr"]) - float(rm["lr"])) <= rc.lr * 2.0 ** -21
        assert int(ts["step"]) == int(rs["step"]) == step + 1
        for kind in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(rs[kind]),
                            jax.tree.leaves(ts[kind])):
                a, b = np.asarray(a, np.float32), b.float().numpy()
                if moments == "float32":
                    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
                else:
                    assert (a != b).sum() <= max(1, 0.01 * a.size)
                    assert np.abs(a - b).max() <= _bf16_ulp(np.abs(a).max())
        for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(tp)):
            assert (_bits(a) != _bits(b)).sum() <= max(1, 0.01 * a.size)
            a32, b32 = np.asarray(a, np.float32), b.float().numpy()
            assert (np.abs(a32 - b32) <= _bf16_ulp(a32)).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compress_grads_matches_reference(dtype):
    """Three steps of error feedback on gradients of mixed scales (a
    half-to-even tie among them): codes, dequantised gradients and
    residuals bit-equal."""
    rng = np.random.default_rng(2)
    dt = getattr(jnp, dtype)
    shapes = {"w": (300, 200), "v": (77,), "z": {"u": (5, 3)}}
    rerr = rgc.init_error_feedback(_tree(lambda s: jnp.zeros(s, dt), shapes))
    terr = init_error_feedback(_tree(lambda s: torch.zeros(s), shapes))
    rstep = jax.jit(rgc.compress_grads)
    for step in range(3):
        g = _tree(lambda s: jnp.asarray(
            rng.standard_normal(s) * 10.0 ** -rng.integers(0, 5), dt), shapes)
        if step == 0:      # g / scale lands on 0.5: round half to even
            g["v"] = g["v"].at[:2].set(jnp.asarray([127.0, 0.5], dt))
        rdeq, rerr = rstep(g, rerr)
        tdeq, terr = compress_grads(jax.tree.map(_to_torch, g), terr)
        for a, b in zip(jax.tree.leaves(rdeq), jax.tree.leaves(tdeq)):
            assert np.array_equal(_bits(a), _bits(b))
        for a, b in zip(jax.tree.leaves(rerr), jax.tree.leaves(terr)):
            assert np.array_equal(_bits(a), _bits(b))
        for leaf in jax.tree.leaves(g):
            g32 = np.asarray(leaf, np.float32)
            with jax.disable_jit():    # max / 127 as a division, op by op
                rq, rscale = rgc._quantize(jnp.asarray(g32))
            tq, tscale = quantize(torch.from_numpy(g32.copy()))
            assert np.array_equal(np.asarray(rq), tq.numpy())
            assert np.float32(rscale) == np.float32(tscale)


def test_compressed_bytes_match_reference():
    shapes = {"w": (300, 200), "v": (77,), "z": {"u": (5, 3)}}
    want = rgc.compressed_bytes(_tree(lambda s: jnp.zeros(s), shapes))
    assert compressed_bytes(_tree(lambda s: torch.zeros(s), shapes)) == want
