"""Step functions of the port: ``train_step`` (loss and gradients, int8
gradient compression with error feedback if asked, then AdamW),
``serve_step`` (one decode step against a cache) and ``prefill_step``
(a whole prompt's logits) — the reference's step builders
(``repro.launch.steps``), as eager PyTorch.  Each takes ``rules=`` (a
:class:`..models.sharding.MeshRules`) and then runs on a mesh under the
rules' activation view: parameters, optimizer state and caches as
DTensors, the batch as this rank's rows (a DTensor of them, or the local
tensor).

``input_specs`` gives every input of a cell's step as tensors on the
``meta`` device, with the reference's shapes and dtypes, nothing
allocated.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import (
    abstract_params, cache_spec, decode_step, lm_loss, lm_loss_terms, prefill,
)
from ..models.sharding import (
    coordinate, current_rules, local, reduce_, sharded_batch_dims, use_rules,
)
from ..optim import AdamWConfig
from ..optim import init as opt_init
from ..optim import update as opt_update
from ..optim.grad_compress import compress_grads, init_error_feedback
from ..tree import map_tree


def default_adamw(cfg: ArchConfig) -> AdamWConfig:
    """The reference's default optimizer for ``cfg``: bf16 moments where
    ``cfg.optimizer_dtype`` says so (grok, nemotron), else f32."""
    return AdamWConfig(moment_dtype=torch.bfloat16
                       if cfg.optimizer_dtype == "bfloat16" else torch.float32)


def loss_and_grads(cfg: ArchConfig, params: dict, batch: dict):
    """``(loss, grads)``: :func:`..models.model.lm_loss` on ``batch``
    (``tokens`` or ``embeds``, and ``labels`` aligned with the
    positions) and its gradient for every parameter, in the params'
    structure and dtypes — zero for a parameter the loss does not reach,
    as ``jax.grad`` gives.  Marks every parameter ``requires_grad``.

    Under rules whose batch dims hold other rows on other ranks, each
    rank differentiates its share — ``ce / n + 0.01 * aux`` for ``n``
    batch shards (``aux`` is global already) — so the gradients, summed
    over the batch ranks as the gathered parameters reduce them, are the
    global batch's; ``loss`` is the global one, the same on every
    rank."""
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    rules = current_rules()
    batch_dims = sharded_batch_dims(rules)
    if batch_dims:
        ce, aux = lm_loss_terms(cfg, params, batch)
        ce = ce / coordinate(rules.mesh, batch_dims)[1]
        objective = ce + 0.01 * aux
        loss = reduce_(ce.detach().clone(), rules.mesh, batch_dims) \
            + 0.01 * aux.detach()
    else:
        objective = loss = lm_loss(cfg, params, batch)
    found = iter(torch.autograd.grad(objective, leaves, allow_unused=True))
    grads = map_tree(lambda p: _or_zeros(next(found), p), params)
    return loss.detach(), grads


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def _act(rules):
    return rules.act() if rules is not None else None


def local_batch(batch: dict) -> dict:
    """A batch's DTensors as this rank's rows."""
    return {k: local(v) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, ocfg: Optional[AdamWConfig] = None,
                    rules=None, grad_compression: bool = False):
    """``(train_step, ocfg)``.  ``train_step(params, opt_state, error_buf,
    batch)`` → ``(params, opt_state, error_buf, {"loss", "grad_norm",
    "lr"})``: :func:`loss_and_grads`, the gradients compressed if asked,
    then :func:`..optim.update`, which writes the parameters and moments
    in place.  The metrics are scalar tensors on the device, so the step
    never waits on the card."""
    ocfg = ocfg or default_adamw(cfg)
    act = _act(rules)

    def train_step(params, opt_state, error_buf, batch):
        with use_rules(act):
            loss, grads = loss_and_grads(cfg, params, local_batch(batch))
            if grad_compression:
                grads, error_buf = compress_grads(grads, error_buf)
            params, opt_state, metrics = opt_update(ocfg, grads, opt_state,
                                                    params)
        return params, opt_state, error_buf, {"loss": loss, **metrics}

    return train_step, ocfg


def make_serve_step(cfg: ArchConfig, rules=None):
    """``serve_step(params, batch, cache)`` → ``(logits, cache)``: one
    decode step (``batch["cache_pos"]`` the first token's position)."""
    act = _act(rules)

    def serve_step(params, batch, cache):
        with use_rules(act):
            return decode_step(cfg, params, local_batch(batch), cache)

    return serve_step


def make_prefill_step(cfg: ArchConfig, rules=None):
    """``prefill_step(params, batch)`` → the prompt's logits."""
    act = _act(rules)

    def prefill_step(params, batch):
        with use_rules(act):
            return prefill(cfg, params, local_batch(batch))

    return prefill_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The host batch of one cell: ``tokens`` (B, S) int32 (or a frontend
    model's ``embeds`` (B, S, d) bf16), ``labels`` for a train cell,
    ``cache_pos`` () int32 for a decode cell, whose S is 1."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    if cfg.uses_tokens:
        b = {"tokens": _meta((B, S), torch.int32)}
    else:
        b = {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
    if shape.kind == "train":
        b["labels"] = _meta((B, S), torch.int32)
    if shape.is_decode:
        b["cache_pos"] = _meta((), torch.int32)
    return b


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The decode cache of ``seq_len`` slots for ``global_batch``."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else _meta(v.shape, v.dtype)
                for k, v in tree.items()}

    return walk(cache_spec(cfg, shape.global_batch, shape.seq_len))


def opt_specs(cfg: ArchConfig, ocfg: AdamWConfig) -> dict:
    return opt_init(ocfg, abstract_params(cfg))


def error_buf_specs(cfg: ArchConfig) -> dict:
    return init_error_feedback(abstract_params(cfg))


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                ocfg: Optional[AdamWConfig] = None) -> dict:
    """Every input of the cell's step function, keyed by argument name."""
    params = abstract_params(cfg)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": opt_specs(cfg, ocfg or default_adamw(cfg)),
                "error_buf": error_buf_specs(cfg),
                "batch": batch_specs(cfg, shape)}
    if shape.is_decode:
        return {"params": params, "batch": batch_specs(cfg, shape),
                "cache": cache_specs(cfg, shape)}
    return {"params": params, "batch": batch_specs(cfg, shape)}
