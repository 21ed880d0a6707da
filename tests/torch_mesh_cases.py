"""Multi-rank cases of the port's mesh layer (no JAX): gloo ranks on the
CPU, started by :func:`run_world`, each writing what it computed for the
test to compare.  Imported by ``tests/test_torch_mesh_*.py`` and by the
spawned ranks, which must not import JAX."""

from __future__ import annotations

import os
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode


def _rank_main(fn, rank: int, world: int, store: str, out: str, args,
               backend: str = "gloo"):
    torch.set_num_threads(1)
    if backend == "nccl":           # a card a rank
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = fn(rank, *args)
        if res is not None:
            torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, tmp, *args, timeout: float = 120.0,
              backend: str = "gloo") -> list:
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks (a ``FileStore``
    under ``tmp``, one thread each; ``backend="nccl"``: NCCL ranks, rank
    r on card r); their return values, by rank.  A rank that fails
    fails the call with its traceback; one that outlives ``timeout``
    seconds is killed and fails it too."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, tmp, args, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    if hung or errs or any(p.exitcode for p in procs):
        raise AssertionError(f"ranks hung past {timeout} s: {hung}; exit "
                             f"codes {[p.exitcode for p in procs]}\n"
                             + "\n".join(errs))
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
        if os.path.exists(path):
            os.remove(path)
    return out


# ---------------------------------------------------------------------------
# helpers the cases share
# ---------------------------------------------------------------------------

def to_np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_np(a: np.ndarray, bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.int16).view(torch.bfloat16) if bf16 else t


def mesh(shape, axes, device="cpu"):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(tuple(shape), tuple(axes), device=device)


def rows(t: torch.Tensor, m) -> torch.Tensor:
    """This rank's rows of a global batch tensor over the batch dims."""
    from repro_torch.models.sharding import axis_names, coordinate

    idx, n = coordinate(m, tuple(a for a in ("pod", "data")
                                 if a in axis_names(m)))
    per = t.shape[0] // n
    return t[idx * per : (idx + 1) * per]


def world_gather(t: torch.Tensor) -> torch.Tensor:
    """``t`` of every rank stacked in rank order (no gradient)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts)


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

EP_B, EP_S = 4, 16


def moe_layer_params(cfg, tree: dict, dtype=None) -> dict:
    """The MoE block's parameters of the first stacked layer."""
    p = {k: v[0] if not isinstance(v, dict) else
         {kk: vv[0] for kk, vv in v.items()}
         for k, v in tree["layers"]["moe"].items()}
    if dtype is not None:
        p = {k: v.to(dtype) if not isinstance(v, dict) else
             {kk: vv.to(dtype) for kk, vv in v.items()} for k, v in p.items()}
    return p


def moe_ep_case(rank, shape, cases, params_np: dict, x_np):
    """One rank of the MoE at ``shape`` (data, model): the port's
    ``moe_block`` under the train cell's rules on the same params (bf16
    and f32), ``sum(out**2) + 0.01 * aux`` differentiated, per case
    ``(capacity factor, experts)`` — with experts that do not divide
    ``model`` the block takes the plain path over the global batch's
    tokens (the params' first ``experts`` experts).  Rank 0 returns, per
    case, the global output, aux, the router / w1 / w2 gradients, the
    (token, choice) keep mask of every rank's token slice, the f32 run's
    gradients and how many times the block took ``moe_block_ep``."""
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import layers
    from repro_torch.models.model import schema
    from repro_torch.models.sharding import distribute, gather_rows, use_rules

    m = mesh(shape, ("data", "model"))
    out = {}
    for capacity, n_experts in cases:
        cfg = dataclasses.replace(smoke_config(ARCHS["deepseek-v2-lite-16b"]),
                                  capacity_factor=capacity,
                                  n_experts=n_experts)
        rules = rules_for(cfg, ShapeConfig("train", EP_S, EP_B, "train"), m)
        spec = schema(cfg)["layers"]["moe"]
        res = out[(capacity, n_experts)] = {"ep_calls": 0}
        for tag, dtype in (("", torch.bfloat16), ("32", torch.float32)):
            keeps = []
            slots, ep = layers.capacity_slots, layers.moe_block_ep

            def recording(experts, n, cap):
                pos, keep = slots(experts, n, cap)
                keeps.append(keep)
                return pos, keep

            def counting(*a, **kw):
                res["ep_calls"] += 1
                return ep(*a, **kw)

            def place(key, s):
                t = from_np(params_np[key], True).to(dtype)
                t = t[tuple(slice(0, n) for n in s.shape[1:])]
                sh = rules.sharding_for_shape(s.axes[1:], s.shape[1:])
                return distribute(t, sh).requires_grad_(True)

            p = {k: {kk: place(f"{k}/{kk}", ss) for kk, ss in v.items()}
                 if isinstance(v, dict) else place(k, v)
                 for k, v in spec.items()}
            x = rows(from_np(x_np, True).to(dtype), m)
            layers.capacity_slots, layers.moe_block_ep = recording, counting
            try:
                with use_rules(rules.act()):
                    o, aux = layers.moe_block(x, p, cfg)
            finally:
                layers.capacity_slots, layers.moe_block_ep = slots, ep
            obj = o.float().square().sum() + 0.01 * aux
            names = ("router", "w1", "w2")
            grads = torch.autograd.grad(obj, [p[n] for n in names])
            for n, g in zip(names, grads):
                res[f"grad_{n}{tag}"] = to_np(g.full_tensor().float())
            o = gather_rows(o.detach(), m, ("data",), partial_grad=True)
            res[f"out{tag}"] = to_np(o.float())
            res[f"aux{tag}"] = float(aux.detach())
            res[f"keep{tag}"] = to_np(world_gather(keeps[0]))
    return out if rank == 0 else None


def start_reference(job: list, inputs: dict, tmp):
    """Start ``tests/torch_mesh_ref.py`` on ``job`` (four host devices);
    ``finish_reference`` collects its results."""
    import json
    import subprocess
    import sys

    tmp = str(tmp)
    paths = [os.path.join(tmp, n) for n in ("job.json", "in.npz", "out.npz")]
    with open(paths[0], "w") as f:
        json.dump(job, f)
    np.savez(paths[1], **inputs)
    here = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(tmp, "ref.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.join(here,
                                                          "torch_mesh_ref.py"),
                             *paths], stdout=log, stderr=subprocess.STDOUT)
    return proc, paths[2], log


def stop_reference(started):
    """Kill the reference run if it is still going (a test that failed
    before collecting it leaves no process behind)."""
    proc, _, log = started
    if proc.poll() is None:
        proc.kill()
        proc.wait(10)
    log.close()


def finish_reference(started, timeout: float = 240.0) -> dict:
    """Wait for the reference run (killed past ``timeout`` seconds) and
    read its results."""
    import subprocess

    proc, out, log = started
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        rc = "killed after its time limit"
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise AssertionError(f"reference run failed ({rc}):\n"
                                 + f.read()[-4000:])
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# train on a mesh
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH = 32, 4


def _stored(tree) -> int:
    from repro_torch.models.sharding import local
    from repro_torch.tree import leaves_with_paths

    return sum(local(t).numel() * local(t).element_size()
               for _, t in leaves_with_paths(tree))


def _shard_bytes(cfg, rules, ocfg) -> int:
    """Bytes of one rank's shards of params, moments and error buffers
    under ``rules``: each leaf's size over its spec's mesh extents."""
    from repro_torch.models.model import leaf_dtype, schema
    from repro_torch.tree import leaves_with_paths

    per_elem_moments = 2 * torch.empty((), dtype=ocfg.moment_dtype
                                       ).element_size()
    total = 0
    for _, s in leaves_with_paths(schema(cfg)):
        spec = rules.spec_for_shape(s.axes, s.shape)
        n = int(np.prod(s.shape))
        for entry in spec:
            n //= rules.axis_size(entry)
        elem = torch.empty((), dtype=leaf_dtype(s.init)).element_size()
        total += n * (elem + per_elem_moments + 2)
    return total


def mesh_world(rank, shape, axes, jobs):
    """Jobs on one mesh: ``("train", name, arch, steps, ckpt_dir or
    None)`` runs ``train(mesh=...)``; ``("restore", name, arch, ckpt_dir,
    step)`` restores a checkpoint onto the mesh; ``("compress",)``,
    ``("remat",)`` and ``("data",)`` run :func:`compress_case`,
    :func:`remat_case` and :func:`data_case`.  Every rank returns, per train run, its stored
    bytes of params, moments and error buffers and what its shards
    should take; rank 0 also the losses, lrs and final params whole, and
    a restore's state whole."""
    m = mesh(shape, axes)
    out = {}
    for job in jobs:
        if job[0] == "train":
            out[job[1]] = _train_run(rank, m, *job[2:])
        elif job[0] == "restore":
            out[job[1]] = _restore_run(rank, m, *job[2:])
        else:
            out[job[0]] = {"compress": compress_case, "remat": remat_case,
                           "data": data_case}[job[0]](rank, m)
    return out


def remat_case(rank, m):
    """``loss_and_grads`` under the train rules with remat on (each layer
    recomputed in the backward, its gathers and, for deepseek, its
    ``all_to_all`` s with it) against remat off, for qwen2-0.5b and
    deepseek-v2-lite-16b at smoke width: the names of the leaves whose
    gradient differs, and the two losses."""
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import init_sharded_params, rules_for
    from repro_torch.launch.steps import local_batch, loss_and_grads
    from repro_torch.models.sharding import full, use_rules
    from repro_torch.tree import leaves_with_paths

    out = {}
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32))
    for arch in TRAIN_ARCHS:
        res = []
        for remat in (False, True):
            cfg = dataclasses.replace(smoke_config(ARCHS[arch]), remat=remat)
            rules = rules_for(cfg, ShapeConfig("train", TRAIN_SEQ,
                                               TRAIN_BATCH, "train"), m)
            params = init_sharded_params(cfg, rules, 0, "cpu")
            t = rows(toks, m)
            with use_rules(rules.act()):
                loss, grads = loss_and_grads(cfg, params, local_batch(
                    {"tokens": t, "labels": t}))
            res.append((float(loss), {k: full(g) for k, g in
                                      leaves_with_paths(grads)}))
        (l0, g0), (l1, g1) = res
        out[arch] = {"losses": (l0, l1),
                     "differ": [k for k in g0 if not torch.equal(g0[k],
                                                                  g1[k])]}
    return out


def data_case(rank, m):
    """``make_train_iterator`` with the train cell's batch sharding: this
    rank's rows of two steps against the stream's rows for its place,
    and the batch DTensor's global shape."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, ShardedTokenStream
    from repro_torch.data.pipeline import batch_rows, make_train_iterator
    from repro_torch.launch.mesh import rules_for

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    rules = rules_for(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), m).act()
    sh = rules.sharding_for_shape(("batch", "seq"), (TRAIN_BATCH, TRAIN_SEQ))
    dcfg = DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    it = make_train_iterator(dcfg, device="cpu", start_step=3,
                             batch_sharding=sh)
    r, w = batch_rows(sh)
    ok = []
    for _ in range(2):
        step, batch = next(it)
        want = ShardedTokenStream(dcfg).batch_at(step, r, w)
        ok.append(all(np.array_equal(batch[k].to_local().numpy(), want[k])
                      and tuple(batch[k].shape) == (TRAIN_BATCH, TRAIN_SEQ)
                      for k in ("tokens", "labels")))
    return {"ok": ok, "rows": (r, w)}


def _train_run(rank, m, arch, steps, ckpt):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.steps import default_adamw
    from repro_torch.launch.train import train
    from repro_torch.models.sharding import full
    from repro_torch.tree import leaves_with_paths

    r = train(arch=arch, steps=steps, smoke=True, seq_len=TRAIN_SEQ,
              global_batch=TRAIN_BATCH, ckpt_dir=ckpt, seed=0,
              device="cpu", mesh=m, log_every=1000)
    cfg = smoke_config(ARCHS[arch])
    res = {"stored": _stored(r["params"]) + _stored(r["opt_state"]["mu"])
           + _stored(r["opt_state"]["nu"]) + _stored(r["err"]),
           "want": _shard_bytes(cfg, r["rules"], default_adamw(cfg)),
           "start": r["start_step"], "losses": r["losses"],
           "lrs": [h["lr"] for h in r["history"]]}
    params = {k: to_np(full(v)) for k, v in leaves_with_paths(r["params"])}
    if rank == 0:
        res["params"] = params
    return res


def _restore_run(rank, m, arch, ckpt, step):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import param_shardings, rules_for
    from repro_torch.models.model import schema
    from repro_torch.models.sharding import full, is_dtensor
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_config(ARCHS[arch])
    rules = rules_for(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), m)
    sh, spec = param_shardings(cfg, rules), schema(cfg)
    state, _ = CheckpointManager(ckpt).restore(
        {"params": spec, "opt": {"mu": spec, "nu": spec, "step": 0},
         "err": spec}, step=step, device="cpu",
        shardings={"params": sh, "opt": {"mu": sh, "nu": sh}, "err": sh})
    leaves = leaves_with_paths(state)
    whole = {k: to_np(full(v)) for k, v in leaves}
    res = {"sharded": sum(is_dtensor(v) for _, v in leaves)}
    if rank == 0:
        res["state"] = whole
    return res


def compress_case(rank, m):
    """A seeded gradient tree and residuals, sharded by qwen2's train
    rules, through ``compress_grads``: each rank's dequantised shards and
    residuals against the same tree compressed whole on this rank (bit
    for bit: the scale is the leaf's max over every rank)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import param_shardings, rules_for, shard_tree
    from repro_torch.models.model import schema
    from repro_torch.models.sharding import local, local_chunk
    from repro_torch.optim.grad_compress import compress_grads
    from repro_torch.tree import leaves_with_paths, map_tree

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    rules = rules_for(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), m)
    sh = param_shardings(cfg, rules)
    gen = torch.Generator().manual_seed(3)
    g = map_tree(lambda s: (torch.randn(s.shape, generator=gen) * 1e-3).to(
        torch.bfloat16), schema(cfg))
    e = map_tree(lambda s: (torch.randn(s.shape, generator=gen) * 1e-5).to(
        torch.bfloat16), schema(cfg))
    whole = compress_grads(g, e)
    parts = compress_grads(shard_tree(g, sh), shard_tree(e, sh))
    shs = dict(leaves_with_paths(sh))
    bad, sharded = [], 0
    for i in range(2):
        w = dict(leaves_with_paths(whole[i]))
        for k, t in leaves_with_paths(parts[i]):
            want = local_chunk(w[k], m, shs[k].placements)
            sharded += any(type(p).__name__ == "Shard"
                           for p in shs[k].placements)
            if not torch.equal(local(t).view(torch.int16),
                               want.view(torch.int16)):
                bad.append(k)
    return {"bad": bad, "sharded": sharded}


# ---------------------------------------------------------------------------
# the train cells of a test module
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")


def seed0_params(arch) -> dict:
    """The port's seed-0 smoke params, leaf path → numpy."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_config(ARCHS[arch])
    return {k: to_np(v) for k, v in
            leaves_with_paths(init_params(cfg, seed=0, device="cpu"))}


def train_cells(tmp, name: str, shape, axes, extra_jobs=(), ckpt=None):
    """The reference's 2 train steps of every arch of
    :data:`TRAIN_ARCHS` on ``shape`` (started first, collected last by
    ``finish_reference``), the port's single-rank runs, and the port's on
    4 gloo ranks (the first arch's checkpointed under ``ckpt``) with
    ``extra_jobs`` after them (:func:`mesh_world`).  Returns
    ``(reference handle, single, per-rank mesh results)``; the caller
    collects the reference (``finish_reference``, ``stop_reference``)."""
    inputs, job = {}, []
    for arch in TRAIN_ARCHS:
        inputs.update({f"{arch}/{k}": v for k, v in seed0_params(arch).items()})
        job.append({"kind": "train", "name": f"{arch}/{name}", "arch": arch,
                    "params": arch, "mesh": list(shape), "axes": list(axes),
                    "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "steps": 2})
    ref = start_reference(job, inputs, tmp)
    try:
        single, port = _train_runs(tmp, name, shape, axes, extra_jobs, ckpt)
    except BaseException:
        stop_reference(ref)
        raise
    return ref, single, port


def _train_runs(tmp, name, shape, axes, extra_jobs, ckpt):
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves_with_paths

    single = {}
    for arch in TRAIN_ARCHS:
        r = train(arch=arch, steps=2, smoke=True, seq_len=TRAIN_SEQ,
                  global_batch=TRAIN_BATCH, seed=0, device="cpu",
                  log_every=1000)
        single[arch] = {"losses": r["losses"],
                        "lrs": [h["lr"] for h in r["history"]],
                        "params": {k: to_np(v) for k, v in
                                   leaves_with_paths(r["params"])}}
    jobs = [("train", f"{a}/{name}", a, 2, ckpt if a == TRAIN_ARCHS[0]
             else None) for a in TRAIN_ARCHS]
    port = run_world(mesh_world, 4, os.path.join(str(tmp), f"w{name}"),
                     shape, axes, jobs + [("compress",)] + list(extra_jobs))
    return single, port


def _float(a):
    import ml_dtypes

    return (a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a
            ).astype(np.float32)


def assert_params_close(got: dict, want: dict, lr_sum: float):
    """At least 99 % of all elements bit-equal; every element within one
    bf16 ulp of itself or ``2 * lr_sum`` of the other (AdamW's first
    steps move an element by about lr)."""
    assert sorted(got) == sorted(want)
    n_diff = n_all = 0
    for k, g in got.items():
        a, b = _float(g), _float(want[k])
        n_diff, n_all = n_diff + int((a != b).sum()), n_all + a.size
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert ((np.abs(a - b) <= ulp) | (np.abs(a - b) <= 2 * lr_sum)).all(), k
    assert n_diff <= 0.01 * n_all


def check_train_cell(single, port, ref, arch, name, loss_rtol=1e-4,
                     ref_loss_atol=1e-2):
    """Rank 0's run of ``arch`` on mesh ``name`` against the single-rank
    run (losses within ``loss_rtol`` relative, lrs equal, params by
    :func:`assert_params_close`) and against the reference's on the mesh
    (losses within ``ref_loss_atol``, params likewise)."""
    got, want = port[0][f"{arch}/{name}"], single[arch]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol,
                               atol=0)
    assert got["lrs"] == want["lrs"]
    assert_params_close(got["params"], want["params"], sum(want["lrs"]))
    rl = ref[f"{arch}/{name}/losses"]
    assert np.abs(np.asarray(got["losses"]) - rl).max() <= ref_loss_atol
    prefix = f"{arch}/{name}/params/"
    assert_params_close(got["params"], {k[len(prefix):]: v for k, v in
                                        ref.items() if k.startswith(prefix)},
                        sum(got["lrs"]))


# ---------------------------------------------------------------------------
# the pipelined prefill and a serve step under decode rules
# ---------------------------------------------------------------------------

PP_LAYERS, PP_B, PP_S = 4, 4, 16


def pp_config():
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_config

    return dataclasses.replace(smoke_config(ARCHS["stablelm-12b"]),
                               n_layers=PP_LAYERS, remat=False)


def pipeline_case(rank, shape, n_micros, params_np: dict, tokens):
    """``make_pp_prefill_step`` on a (stage, data, model) mesh, per
    ``n_micro``: the logits every rank returns (rank 0's, and whether
    every rank's equal it)."""
    from repro_torch.launch.pipeline import make_pp_prefill_step
    from repro_torch.models.model import schema

    cfg = pp_config()
    m = mesh(shape, ("stage", "data", "model"))
    params = {}
    for k, a in params_np.items():
        node, parts = params, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = from_np(a, a.dtype == np.uint16)
    assert set(params) == set(schema(cfg))
    toks = torch.from_numpy(tokens)
    out = {}
    for n in n_micros:
        logits = make_pp_prefill_step(cfg, m, n_micro=n)(params,
                                                         {"tokens": toks})
        same = bool((world_gather(logits.float()) == logits.float()).all())
        out[n] = {"logits": to_np(logits.float()), "same": same}
    return out if rank == 0 else None


SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX = 2, 16, 4, 32


def serve_case(rank, shape, tokens):
    """qwen2-0.5b at smoke width on a (data, model) mesh under the decode
    cell's rules: params placed by ``param_shardings``, the cache by
    ``cache_shardings`` (its sequence over ``model``), a prompt then
    single-token ``serve_step`` s; rank 0 returns the steps' logits and
    the cache leaves' placements."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import (
        cache_shardings, init_sharded_params, rules_for, shard_tree,
    )
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.model import init_cache
    from repro_torch.models.sharding import local

    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    m = mesh(shape, ("data", "model"))
    rules = rules_for(cfg, ShapeConfig("decode", SERVE_MAX, SERVE_B,
                                       "decode"), m)
    params = init_sharded_params(cfg, rules, seed=0, device="cpu")
    cache = init_cache(cfg, SERVE_B, SERVE_MAX, device="cpu")
    cache = shard_tree(cache, cache_shardings(cfg, rules, cache))
    step = make_serve_step(cfg, rules)
    toks = rows(torch.from_numpy(tokens), m)
    logits, cache = step(params, {"tokens": toks[:, :SERVE_PROMPT],
                                  "cache_pos": 0}, cache)
    seq = [logits[:, -1]]
    for t in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS):
        logits, cache = step(params, {"tokens": toks[:, t : t + 1],
                                      "cache_pos": t}, cache)
        seq.append(logits[:, 0])
    k = cache["layers"]["k"]
    return {"logits": to_np(torch.stack(seq, 1).float()),
            "placements": [(type(p).__name__, getattr(p, "dim", None))
                           for p in k.placements],
            "local_seq": local(k).shape[2]} if rank == 0 else None


# ---------------------------------------------------------------------------
# the mesh train step as a CUDA graph would capture it
# ---------------------------------------------------------------------------

class StepAudit:
    """Records what a CUDA graph capture of a step could not take, and the
    step's collectives.  A context manager around one step; it enters a
    ``TorchDispatchMode`` that sees this rank's local ops (a DTensor op is
    let through to DTensor, whose local ops and collectives come back to
    the mode, as ``launch/dryrun.py`` does).  ``faults``: a read of a
    device value on the host (``_local_scalar_dense``), an op whose
    output shape depends on the data, or a copy between devices, each
    with the port's line it came from.  A 0-d host tensor (the port's
    ``torch.tensor`` scalars, and what is computed from them alone) may be
    read: it never leaves the host.  ``F.one_hot``'s range checks read
    its input on the CPU only (on the card a device assert replaces
    them), so reads inside it on the CPU are not faults.
    ``collectives``: every ``c10d`` op in order, with its tensors' shapes
    and dtypes and its group's size."""

    def __init__(self):
        self.faults, self.collectives = [], []
        self.host = weakref.WeakSet()      # tensors that live on the host
        self.in_one_hot = 0
        self._modes = (_AuditCalls(self), _AuditOps(self))

    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


class _AuditOps(TorchDispatchMode):
    def __init__(self, audit: StepAudit):
        super().__init__()
        self.audit = audit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs, audit = kwargs or {}, self.audit
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)        # sharding propagation
        ins = _tensors_in(args, kwargs)
        fault = _capture_fault(func, args, kwargs, audit)
        if fault:
            audit.faults.append((fault, str(func), _port_site()))
        out = func(*args, **kwargs)
        if func in (torch.ops.aten.lift_fresh.default,
                    torch.ops.aten.lift_fresh_copy.default) \
                or (ins and all(t in audit.host for t in ins)):
            for t in _tensors_in((out,), {}):
                audit.host.add(t)
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            audit.collectives.append(_collective_record(func, args, kwargs))
        return out


class _AuditCalls(TorchFunctionMode):
    """Counts the ``F.one_hot`` calls the step is inside."""

    def __init__(self, audit: StepAudit):
        super().__init__()
        self.audit = audit

    def __torch_function__(self, func, types, args=(), kwargs=None):
        inside = func is torch.nn.functional.one_hot
        self.audit.in_one_hot += inside
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.audit.in_one_hot -= inside


def _tensors_in(args, kwargs) -> list:
    out = []
    for a in list(args) + list(kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor):
                out.append(t)
    return out


def _capture_fault(func, args, kwargs, audit: StepAudit):
    aten = torch.ops.aten
    if func is aten._local_scalar_dense.default:
        t = args[0]
        if t in audit.host or (audit.in_one_hot and t.device.type == "cpu"):
            return None
        return "host read"
    if func is aten.index.Tensor:    # integer indices keep their shape
        if any(i is not None and i.dtype in (torch.bool, torch.uint8)
               for i in args[1]):
            return "data-dependent shape"
        return None
    if torch.Tag.dynamic_output_shape in func.tags:
        return "data-dependent shape"
    if func is aten._to_copy.default and "device" in kwargs \
            and torch.device(kwargs["device"]) != args[0].device:
        return "copy between devices"
    if func is aten.copy_.default and args[0].device != args[1].device:
        return "copy between devices"
    return None


def _port_site() -> str:
    """The innermost frame of the port's package: where an op came from."""
    import sys

    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if f"{os.sep}repro_torch{os.sep}" in name:
            return (f"{name.split(os.sep + 'repro_torch' + os.sep)[1]}:"
                    f"{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return "?"


def _collective_record(func, args, kwargs) -> tuple:
    from repro_torch.launch.dryrun import _group_ranks

    shapes = tuple((tuple(t.shape), str(t.dtype))
                   for t in _tensors_in(args, kwargs))
    try:
        size = len(_group_ranks(func, args, kwargs))
    except RuntimeError:        # wait_tensor: no group
        size = None
    return (f"{func.namespace}.{func._opname}", shapes, size)


GRAPH_STEPS = 3     # the warm-up, the step a card captures, a replay


def graph_case(rank, shapes, device="cpu"):
    """Per (data, model) mesh of ``shapes`` and per arch of
    :data:`TRAIN_ARCHS` at smoke width, under deterministic algorithms,
    :data:`GRAPH_STEPS` steps of 4 x 32 tokens three ways: the plain
    ``make_train_step`` loop on the mesh; a ``TrainGraph`` (on a card the
    warm-up, the capture and a replay), each step under a
    :class:`StepAudit` (its faults and collectives) and, on a card, the
    last under ``torch.profiler`` (the replay's kernels and copies, and
    the NCCL kernels among them); and ``train(mesh=...)``.  Every rank
    returns, per ``(shape, arch)``: the audits, whether the
    ``TrainGraph`` would capture and did, whether every leaf of its state
    (a DTensor's local shard) kept its storage, ``train``'s ``capture_s``,
    whether the ``TrainGraph`` run and ``train`` equal the plain loop bit
    for bit (metrics, and every leaf of the final state whole), and the
    replay's ``kernels`` and ``nccl`` (None on the CPU)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, ShardedTokenStream
    from repro_torch.data.pipeline import batch_rows
    from repro_torch.launch.mesh import init_sharded_params, rules_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainGraph, train
    from repro_torch.models.sharding import full
    from repro_torch.optim import init as opt_init
    from repro_torch.optim.grad_compress import init_error_feedback
    from repro_torch.tree import leaves_with_paths

    dev = torch.device("cuda", rank) if device == "cuda" \
        else torch.device(device)

    def metrics(m_):
        return tuple(float(m_[k]) for k in ("loss", "grad_norm", "lr"))

    def whole(params, state, err):
        return {k: to_np(full(v)) for k, v in leaves_with_paths(
            {"params": params, "opt": state, "err": err})}

    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for shape in shapes:
            m = mesh(shape, ("data", "model"), device)
            for arch in TRAIN_ARCHS:
                cfg = smoke_config(ARCHS[arch])
                rules = rules_for(cfg, ShapeConfig(
                    "train", TRAIN_SEQ, TRAIN_BATCH, "train"), m)
                r, w = batch_rows(rules.act().sharding_for_shape(
                    ("batch", "seq"), (TRAIN_BATCH, TRAIN_SEQ)))
                data = ShardedTokenStream(DataConfig(
                    cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))
                batches = []
                for i in range(GRAPH_STEPS):
                    t = torch.from_numpy(np.ascontiguousarray(
                        data.batch_at(i, r, w)["tokens"])).to(dev)
                    batches.append({"tokens": t, "labels": t})

                def fresh():
                    step, ocfg = make_train_step(cfg, rules=rules,
                                                 grad_compression=True)
                    params = init_sharded_params(cfg, rules, 0, dev)
                    return step, params, opt_init(ocfg, params), \
                        init_error_feedback(params)

                step, *state = fresh()
                plain = []
                for b in batches:
                    *state, mt = step(*state, b)
                    plain.append(metrics(mt))
                want = whole(*state)
                del state

                step, *state = fresh()
                run = TrainGraph(step, *state)
                storage = _storages(run.state)
                audits, graphed = [], []
                kernels = nccl = None
                for i, b in enumerate(batches):
                    audit = StepAudit()
                    last = dev.type == "cuda" and i == len(batches) - 1
                    with audit, _device_profile(last) as names:
                        mt = run(b)
                    graphed.append(metrics(mt))
                    audits.append({"faults": audit.faults,
                                   "collectives": audit.collectives})
                    if last:
                        kernels = len(names)
                        nccl = sum("nccl" in n.lower() for n in names)
                got = whole(run.params, run.opt_state, run.err)
                res = {"audits": audits, "captures": run.captures,
                       "graph": run.graph is not None,
                       "storage_kept": _storages(run.state) == storage,
                       "kernels": kernels, "nccl": nccl,
                       "graph_eq": graphed == plain and _same(got, want)}
                del run, state

                tr = train(arch=arch, steps=GRAPH_STEPS, smoke=True,
                           seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                           seed=0, device=dev, mesh=m, log_every=1000)
                res["capture_s"] = tr["capture_s"]
                res["train_eq"] = [
                    tuple(h[k] for k in ("loss", "grad_norm", "lr"))
                    for h in tr["history"]] == plain and _same(
                        whole(tr["params"], tr["opt_state"], tr["err"]),
                        want)
                out[(tuple(shape), arch)] = res
                del tr
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _storages(tree) -> dict:
    """Each leaf's storage (a DTensor's local shard's), by path."""
    from repro_torch.models.sharding import local
    from repro_torch.tree import leaves_with_paths

    return {k: local(v).untyped_storage().data_ptr()
            for k, v in leaves_with_paths(tree)}


def _same(got: dict, want: dict) -> bool:
    return all(np.array_equal(got[k], want[k]) for k in want)


class _device_profile:
    """``torch.profiler`` over the block when ``on`` (device activity);
    yields a list it fills, on exit, with the names of the kernels and
    copies that ran on the card."""

    def __init__(self, on: bool):
        self.on, self.names, self.prof = on, [], None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self.names

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            self.names.extend(
                e.name() for e in self.prof.profiler.kineto_results.events()
                if "CUDA" in str(e.device_type()))
        return False
