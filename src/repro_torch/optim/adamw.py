"""AdamW with global-norm clipping, a warmup-cosine schedule and optional
bf16 moments — the reference's ``repro.optim.adamw``, over the port's
parameter dicts.

Functional as the reference's (``init`` / ``update``), so the optimizer
state is a dict of tensors the checkpoint stores as it is: ``mu`` and
``nu`` in the parameters' structure and an int32 ``step``.  On a mesh
the moments are DTensors with their parameters' placements, the update
runs on each rank's shards, and the global norm sums every shard once.
Not
``torch.optim.AdamW``: the reference's update is ``p − lr·(m̂/(√v̂ + eps)
+ wd·p)`` with decay on matrices only (``ndim ≥ 2``), in this order of
f32 ops, which the port keeps.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.sharding import is_dtensor, local
from ..tree import leaves_with_paths, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor; f32 result on its
    device): a linear warmup over ``warmup_steps``, then a cosine from
    ``lr`` down to ``0.1 * lr`` at ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter (with
    its placements, on a mesh), and ``step`` 0 (int32, on the parameters'
    device)."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.moment_dtype,  # noqa: E731
                                       requires_grad=False)
    dev = local(leaves_with_paths(params)[0][1]).device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _counted_once(x) -> bool:
    """Whether this rank's shard of a DTensor enters a sum over the whole
    world: on the first rank of every mesh dim the leaf is replicated
    over, so each element counts once."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    return all(mesh.get_local_rank(i) == 0
               for i, p in enumerate(x.placements) if isinstance(p, Replicate))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves, in the reference's order (sorted
    keys), of each leaf's f32 sum of squares — over the whole leaf, for a
    DTensor (its shards' sums added by one all-reduce on the default
    group: the group's stream waits on the caller's and the caller's on
    it through events, and nothing on the host waits, so a CUDA graph
    captures it)."""
    leaves = [x for _, x in leaves_with_paths(tree)]
    sums = [local(x).float().square().sum() for x in leaves]
    sharded = [is_dtensor(x) for x in leaves]
    if any(sharded):
        import torch.distributed as dist

        part = torch.stack([s if not d or _counted_once(x) else
                            torch.zeros_like(s)
                            for s, d, x in zip(sums, sharded, leaves)])
        dist.all_reduce(part)
        sums = [part[i] if d else s
                for i, (s, d) in enumerate(zip(sums, sharded))]
    sq = None
    for s in sums:
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """One AdamW step → ``(params, state, {"grad_norm", "lr"})``.

    Clips by the global norm (``scale = min(1, clip / (norm + 1e-9))``),
    updates the moments in f32, bias-corrects them, decays matrices, and
    writes the new parameters (rounded to their dtype) and moments
    (rounded to ``moment_dtype``) **in place** into ``params`` and
    ``state`` (a DTensor's local shard), which it returns: the step holds
    no second copy of the train state.  The metrics are f32 scalar
    tensors on the device."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    mus, nus = dict(leaves_with_paths(state["mu"])), \
        dict(leaves_with_paths(state["nu"]))
    gs = dict(leaves_with_paths(grads))
    for path, p in leaves_with_paths(params):
        p, m, v = local(p), local(mus[path]), local(nus[path])
        g = local(gs[path]).float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if p.ndim >= 2:     # decay matrices only
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
