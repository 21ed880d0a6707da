"""The reference's side of the port's mesh tests, run as a subprocess
with four host devices (``tests/conftest.py`` has already started JAX
with one in the test process):

    python tests/torch_mesh_ref.py JOB.json IN.npz OUT.npz

``JOB.json`` lists the cases of one test file; ``IN.npz`` holds the
inputs the port uses too (bf16 as uint16 bits); ``OUT.npz`` gets every
case's results, keyed ``<case>/<name>``.  Kinds:

* ``moe_ep``: deepseek-v2-lite-16b at smoke width, one MoE layer under
  the train cell's rules at a (data, model) mesh: the jitted
  ``moe_block`` (the expert-parallel path, or with experts that do not
  divide ``model`` the plain one) output and aux, the jitted
  ``jax.grad`` of ``sum(out**2) + 0.01 * aux`` for router, w1 and w2,
  and each token slice's keep mask from ``_local_dispatch`` op by op
  (the whole batch one slice on the plain path);
* ``train``: ``make_train_step(rules=...)`` jitted on a mesh, the
  params placed by ``param_shardings``: the losses of the steps and the
  params after them;
* ``pipeline``: ``make_pp_prefill_step`` on a (stage, data, model)
  mesh: the logits; and, with ``forward``, the jitted ``forward``'s.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS, smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import mesh as mesh_lib  # noqa: E402


def _bf16(a):
    return jnp.asarray(np.asarray(a).view(ml_dtypes.bfloat16))


def _tree(inp, prefix):
    """The nested dict stored under ``prefix`` (keys ``prefix/a/b``)."""
    out = {}
    for k in inp.files:
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        a = inp[k]
        node[parts[-1]] = _bf16(a) if a.dtype == np.uint16 else jnp.asarray(a)
    return out


def _np(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def moe_ep(case, inp, out):
    from repro.models import layers as L
    from repro.models.sharding import use_rules

    cfg = dataclasses.replace(smoke_config(ARCHS["deepseek-v2-lite-16b"]),
                              capacity_factor=case["capacity"],
                              n_experts=case["experts"])
    p = _tree(inp, "moe")
    E = cfg.n_experts                   # the first E experts of the params
    p["router"] = p["router"][:, :E]
    for k in ("w1", "w2", "w3"):
        p[k] = p[k][:E]
    x = _bf16(inp["moe_x"])
    B, S, d = x.shape
    mesh = mesh_lib.make_mesh(tuple(case["mesh"]), ("data", "model"))
    rules = mesh_lib.rules_for(cfg, ShapeConfig("train", S, B, "train"),
                               mesh).act()

    def block(p, x):
        with use_rules(rules):
            return L.moe_block(x, p, cfg)

    def loss(p):
        o, aux = block(p, x)
        return jnp.sum(jnp.square(o.astype(jnp.float32))) + 0.01 * aux

    o, aux = jax.jit(block)(p, x)
    g = jax.jit(jax.grad(loss))(p)
    name = case["name"]
    out[f"{name}/out"] = np.asarray(o, np.float32)
    out[f"{name}/aux"] = np.float32(aux)
    for k in ("router", "w1", "w2"):
        out[f"{name}/grad_{k}"] = np.asarray(g[k], np.float32)
    # each token slice's routing, op by op, at the local capacity
    n = int(np.prod(case["mesh"])) if E % case["mesh"][1] == 0 else 1
    T_l = B * S // n
    cap = int(max(1, cfg.capacity_factor * cfg.top_k * T_l / cfg.n_experts))
    with jax.disable_jit():
        h = L.norm(x, p["norm"], cfg.norm).reshape(B * S, d)
        keeps = [np.asarray(L._local_dispatch(h[i * T_l:(i + 1) * T_l], cfg,
                                              cap, p["router"])[3])
                 for i in range(n)]
    out[f"{name}/keep"] = np.stack(keeps)


def train(case, inp, out):
    from repro.data import DataConfig, ShardedTokenStream
    from repro.launch.steps import make_train_step
    from repro.optim import init as opt_init
    from repro.optim.grad_compress import init_error_feedback

    cfg = smoke_config(ARCHS[case["arch"]])
    params = _tree(inp, case["params"])
    axes = tuple(case["axes"])
    mesh = mesh_lib.make_mesh(tuple(case["mesh"]), axes)
    shape = ShapeConfig("train", case["seq"], case["batch"], "train")
    rules = mesh_lib.rules_for(cfg, shape, mesh)
    params = jax.device_put(params, mesh_lib.param_shardings(cfg, rules))
    step, ocfg = make_train_step(cfg, rules=rules, grad_compression=True)
    step = jax.jit(step)
    opt, err = opt_init(ocfg, params), init_error_feedback(params)
    data = ShardedTokenStream(DataConfig(cfg.vocab, case["seq"],
                                         case["batch"], seed=0))
    losses = []
    for s in range(case["steps"]):
        toks = jnp.asarray(data.batch_at(s)["tokens"])
        params, opt, err, m = step(params, opt, err,
                                   {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
    name = case["name"]
    out[f"{name}/losses"] = np.asarray(losses, np.float64)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(k.key) for k in path)
        out[f"{name}/params/{key}"] = _np(leaf)


def pipeline(case, inp, out):
    from repro.launch.pipeline import make_pp_prefill_step

    cfg = dataclasses.replace(smoke_config(ARCHS["stablelm-12b"]),
                              n_layers=case["layers"], remat=False)
    params = _tree(inp, "pp")
    mesh = mesh_lib.make_mesh(tuple(case["mesh"]), ("stage", "data", "model"))
    step = jax.jit(make_pp_prefill_step(cfg, mesh, n_micro=case["n_micro"]))
    batch = {"tokens": jnp.asarray(inp["pp_tokens"])}
    out[f"{case['name']}/logits"] = np.asarray(step(params, batch),
                                               np.float32)
    if case.get("forward"):
        from repro.models import forward

        logits = jax.jit(lambda p, b: forward(cfg, p, b)[0])(params, batch)
        out["forward/logits"] = np.asarray(logits, np.float32)


def main(job_path, in_path, out_path):
    with open(job_path) as f:
        job = json.load(f)
    out = {}
    with np.load(in_path) as inp:
        for case in job:
            {"moe_ep": moe_ep, "train": train,
             "pipeline": pipeline}[case["kind"]](case, inp, out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:4])
