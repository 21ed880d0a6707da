"""Port vs reference: the training loss, its gradients, the MoE aux loss
and remat, for every arch of ``ARCHS`` at ``smoke_config``.

The same params (``params_from_jax`` of the reference's draw) and the
same batch of (2, 32) tokens (or bf16 embeds) with labels aligned to
the positions go through the reference's jitted ``value_and_grad`` of
``lm_loss`` and the port's ``lm_loss`` + ``autograd``, and through the
port in f32 (params cast, activations f32), which stands for the exact
gradient.  Tolerances:

* the loss within 1e-2 of the reference's and of the f32 loss (measured
  ≤ 2.4e-3 and ≤ 2.6e-3: bf16 activations round at other places);
* every leaf's gradient within 5 % relative L2 of the f32 gradient
  (measured ≤ 3.5 %), and within ``0.03 + r`` of the reference's, where
  ``r`` is the reference's own distance from the f32 gradient (measured
  ≤ 2.0 % for every arch but zamba2, whose 4-head ``D`` / ``A_log``
  leaves sum many cancelling terms: 5.3 % there, with the reference
  6.2 % from f32 — the two bf16 gradients differ by bf16 noise, each as
  far from f32 as the other).  grok-1 was 9–29 % off on every leaf
  while the port lacked the aux loss: its gradient reaches every layer
  through the router's probabilities; with it, 1.7 %;
* the MoE aux loss and the router's gradient against the reference run
  op by op (``jax.disable_jit()``, bf16 router logits as its source
  names them), on the same routes (asserted first): the aux within 2
  f32 ulps, the router gradient within 2 bf16 ulps of its largest value
  (a bf16 (d, T) x (T, E) product summed in another order: measured
  1.5);
* remat on == remat off, loss and gradients bit for bit (the CPU
  recomputes a layer exactly), with every layer's forward run twice.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import applicable_shapes as rapplicable  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models.model import lm_loss as rlm_loss  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow   # model-forward module

B, S = 2, 32
LOSS_ATOL, F32_RTOL, REF_RTOL = 1e-2, 0.05, 0.03
MOE_ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]


@pytest.fixture(scope="module")
def pairs(smoke_model):
    cache = {}

    def get(name):
        if name not in cache:
            rcfg, rparams = smoke_model(name)
            tcfg = smoke_config(ARCHS[name])
            cache[name] = (rcfg, rparams, tcfg, tm.params_from_jax(
                tcfg, jax.tree.map(np.asarray, rparams), device="cpu"))
        return cache[name]
    return get


def _batches(cfg, seed=1):
    """The same batch for both packages: tokens (or bf16 embeds) and
    labels aligned with the positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    rb = {"labels": jnp.asarray(toks)}
    tb = {"labels": torch.from_numpy(toks)}
    if cfg.uses_tokens:
        rb["tokens"], tb["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    else:
        emb = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                          jnp.bfloat16)
        rb["embeds"] = emb
        tb["embeds"] = torch.from_numpy(
            np.asarray(emb).view(np.int16).copy()).view(torch.bfloat16)
    return rb, tb


def _grads(cfg, params, batch):
    params = tm._map(params, lambda _, t: t.detach().clone())
    loss, grads = tsteps.loss_and_grads(cfg, params, batch)
    return float(loss), {k: g.float().numpy()
                         for k, g in leaves_with_paths(grads)}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RSHAPES.items()}
    from repro.configs import ARCHS as RARCHS

    for name in ARCHS:
        assert [s.name for s in applicable_shapes(ARCHS[name])] == \
            [s.name for s in rapplicable(RARCHS[name])]
    assert SHAPES["decode_32k"].is_decode and not SHAPES["train_4k"].is_decode


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grads_match_reference(pairs, monkeypatch, name):
    rcfg, rparams, tcfg, tparams = pairs(name)
    rb, tb = _batches(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: rlm_loss(rcfg, p, rb)))(rparams)
    jg = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
          for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    loss, grads = _grads(tcfg, tparams, tb)
    monkeypatch.setattr(tm, "DTYPE", torch.float32)   # the frontends' embeds
    b32 = {k: v.float() if v.is_floating_point() else v for k, v in tb.items()}
    loss32, grads32 = _grads(tcfg, tm._map(tparams, lambda _, t: t.float()),
                             b32)
    assert np.isfinite(loss)
    assert abs(loss - float(jl)) <= LOSS_ATOL
    assert abs(loss - loss32) <= LOSS_ATOL
    assert list(grads) == list(jg)
    for k, g in grads.items():
        assert g.shape == jg[k].shape and np.isfinite(g).all(), k
        assert _rel(g, grads32[k]) <= F32_RTOL, k
        assert _rel(g, jg[k]) <= REF_RTOL + _rel(jg[k], grads32[k]), k


@pytest.fixture(scope="module")
def moe_layers(pairs):
    """Per MoE arch: the reference cfg and its last stacked MoE layer's
    params, the port cfg and the same params."""
    out = {}
    for name in MOE_ARCHS:
        rcfg, rparams, tcfg, tparams = pairs(name)
        out[name] = (rcfg, jax.tree.map(lambda a: a[-1],
                                        rparams["layers"]["moe"]),
                     tcfg, tm._layer(tparams["layers"], -1)["moe"])
    return out


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_aux_and_router_grad_equal_reference(moe_layers, name):
    """One MoE block, op by op in the reference: ``sum(out * w) + aux``
    differentiated for the router."""
    rcfg, rp, tcfg, tp = moe_layers[name]
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((B, 40, tcfg.d_model)), jnp.bfloat16)
    w = rng.standard_normal((B, 40, tcfg.d_model)).astype(np.float32)
    T = B * 40

    def rloss(router):
        out, aux = rlayers.moe_block(x, dict(rp, router=router), rcfg)
        return jnp.sum(out.astype(jnp.float32) * w) + aux, aux

    with jax.disable_jit():
        h = rlayers.norm(x, rp["norm"], rcfg.norm).reshape(T, -1)
        cap = int(max(1, tcfg.capacity_factor * tcfg.top_k * T
                      / tcfg.n_experts))
        experts = rlayers._local_dispatch(h, rcfg, cap, rp["router"])[5]
        (_, raux), rgrad = jax.value_and_grad(rloss, has_aux=True)(
            rp["router"])
    xt = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)
    ht = tlayers.norm(xt, tp["norm"], tcfg.norm).reshape(T, -1)
    assert np.array_equal(tlayers.route(ht, tp["router"], tcfg.top_k)[1]
                          .numpy(), np.asarray(experts))
    router = tp["router"].detach().clone().requires_grad_(True)
    out, aux = tlayers.moe_block(xt, dict(tp, router=router), tcfg)
    ((out.float() * torch.from_numpy(w)).sum() + aux).backward()
    raux = np.float32(raux)
    assert abs(np.float32(aux.item()) - raux) <= 2 * np.spacing(raux)
    rgrad = np.asarray(rgrad, np.float32)
    top = np.abs(rgrad).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(router.grad.float().numpy() - rgrad).max() <= 2 * ulp


def test_aux_is_zero_for_a_single_token_and_other_families(pairs):
    """A single token (the dense decode path) has no balance loss: the
    block returns None and the forward an f32 zero, the reference's
    value; so does every family without a MoE."""
    _, _, tcfg, tp = pairs("deepseek-v2-lite-16b")
    x = torch.randn(B, 1, tcfg.d_model).to(torch.bfloat16)
    _, aux = tlayers.moe_block(x, tm._layer(tp["layers"], 0)["moe"], tcfg)
    assert aux is None
    cache = tm.init_cache(tcfg, B, 4, device="cpu")
    _, _, aux = tm.forward_with_aux(tcfg, tp, {
        "tokens": torch.zeros(B, 1, dtype=torch.int32), "cache_pos": 0},
        cache)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    for name in ("qwen2-0.5b", "falcon-mamba-7b", "zamba2-7b"):
        _, _, cfg, params = pairs(name)
        toks = torch.from_numpy(_batches(cfg)[1]["tokens"].numpy())
        _, _, aux = tm.forward_with_aux(cfg, params, {"tokens": toks})
        assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_aux_sums_only_the_stacked_layers(pairs, monkeypatch):
    """deepseek's leading dense layer has no MoE; the forward's aux is
    the sum of the stacked MoE layers' balance losses, in layer order."""
    _, _, cfg, params = pairs("deepseek-v2-lite-16b")
    seen = []
    balance = tlayers.balance_loss

    def recording(probs, experts):
        seen.append(balance(probs, experts))
        return seen[-1]
    monkeypatch.setattr(tlayers, "balance_loss", recording)
    toks = _batches(cfg)[1]["tokens"]
    with torch.no_grad():
        _, _, aux = tm.forward_with_aux(cfg, params, {"tokens": toks})
    assert len(seen) == tm.cfg_layers(cfg) >= 1
    want = torch.zeros((), dtype=torch.float32)
    for a in seen:
        want = want + a
    assert torch.equal(aux, want)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b", "zamba2-7b",
                                  "hubert-xlarge"])
def test_remat_is_bit_equal(pairs, monkeypatch, name):
    """``cfg.remat`` checkpoints each layer: the loss and every gradient
    bit-equal to the run without it, each layer's mixer called twice
    (forward, then the recompute in the backward); never without
    autograd."""
    _, _, cfg, params = pairs(name)
    tb = _batches(cfg)[1]
    mixer = {"falcon-mamba-7b": "mamba1_mix", "zamba2-7b": "mamba2_mix",
             "deepseek-v2-lite-16b": "mla_block"}.get(name, "gqa_block")
    calls = []
    original = getattr(tlayers, mixer)

    def counting(*a, **kw):
        calls.append(1)
        return original(*a, **kw)
    monkeypatch.setattr(tlayers, mixer, counting)
    runs = {}
    for remat in (False, True):
        calls.clear()
        runs[remat] = _grads(dataclasses.replace(cfg, remat=remat), params,
                             tb)
        runs[remat] += (len(calls),)
    assert runs[True][0] == runs[False][0]
    for k, g in runs[False][1].items():
        assert np.array_equal(runs[True][1][k], g), k
    assert runs[True][2] == 2 * runs[False][2] > 0
    calls.clear()
    with torch.no_grad():
        tm.forward(dataclasses.replace(cfg, remat=True), params,
                   {k: v for k, v in tb.items() if k != "labels"})
    assert len(calls) == runs[False][2]


def test_prefill_and_step_builders(pairs):
    """``prefill`` / ``make_prefill_step`` give the forward's logits
    without autograd; ``make_serve_step`` is ``decode_step``."""
    _, _, cfg, params = pairs("qwen2-0.5b")
    toks = _batches(cfg)[1]["tokens"]
    want, _ = tm.forward(cfg, params, {"tokens": toks})
    got = tm.prefill(cfg, params, {"tokens": toks})
    assert torch.equal(got, want) and not got.requires_grad
    assert torch.equal(tsteps.make_prefill_step(cfg)(params,
                                                     {"tokens": toks}), want)
    serve = tsteps.make_serve_step(cfg)
    c1 = tm.init_cache(cfg, B, S, device="cpu")
    c2 = tm.init_cache(cfg, B, S, device="cpu")
    a, _ = serve(params, {"tokens": toks, "cache_pos": 0}, c1)
    b, _ = tm.decode_step(cfg, params, {"tokens": toks, "cache_pos": 0}, c2)
    assert torch.equal(a, b) and torch.equal(a, want)
