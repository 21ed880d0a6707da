"""Step functions of the port: ``train_step`` (loss and gradients, int8
gradient compression with error feedback if asked, then AdamW),
``serve_step`` (one decode step against a cache) and ``prefill_step``
(a whole prompt's logits) — the reference's step builders
(``repro.launch.steps``), as eager PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..models.model import decode_step, lm_loss, prefill
from ..optim import AdamWConfig
from ..optim import update as opt_update
from ..optim.grad_compress import compress_grads
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
    as ``jax.grad`` gives.  Marks every parameter ``requires_grad``."""
    leaves = []
    map_tree(lambda p: leaves.append(p.requires_grad_(True)), params)
    loss = lm_loss(cfg, params, batch)
    found = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = map_tree(lambda p: _or_zeros(next(found), p), params)
    return loss.detach(), grads


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_train_step(cfg: ArchConfig, ocfg: Optional[AdamWConfig] = None,
                    grad_compression: bool = False):
    """``(train_step, ocfg)``.  ``train_step(params, opt_state, error_buf,
    batch)`` → ``(params, opt_state, error_buf, {"loss", "grad_norm",
    "lr"})``: :func:`loss_and_grads`, the gradients compressed if asked,
    then :func:`..optim.update`, which writes the parameters and moments
    in place.  The metrics are scalar tensors on the device, so the step
    never waits on the card."""
    ocfg = ocfg or default_adamw(cfg)

    def train_step(params, opt_state, error_buf, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        if grad_compression:
            grads, error_buf = compress_grads(grads, error_buf)
        params, opt_state, metrics = opt_update(ocfg, grads, opt_state,
                                                params)
        return params, opt_state, error_buf, {"loss": loss, **metrics}

    return train_step, ocfg


def make_serve_step(cfg: ArchConfig):
    """``serve_step(params, batch, cache)`` → ``(logits, cache)``: one
    decode step (``batch["cache_pos"]`` the first token's position)."""
    def serve_step(params, batch, cache):
        return decode_step(cfg, params, batch, cache)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)`` → the prompt's logits."""
    def prefill_step(params, batch):
        return prefill(cfg, params, batch)

    return prefill_step
