"""Pipeline parallelism (GPipe) over a ``stage`` mesh dim — the
reference's ``repro.launch.pipeline``, with point-to-point sends.

Each stage holds ``cfg_layers / n_stages`` of the stacked layers; the
embedding, the head and the final norm are on every rank.  Schedule:
GPipe fill-drain, T = n_micro + n_stages − 1 ticks; at tick t stage s
runs microbatch t − s when 0 ≤ t − s < n_micro.  Stage 0 embeds its
microbatch; every other stage receives its input from stage s − 1 (sent
at the tick before) and the last stage applies the final norm and the
head.  The logits are summed over the stage group (zeros on every stage
but the last), so every rank returns them.  ``data`` splits the batch's
rows; ``model`` ranks repeat their stage's work.

Scope, as the reference's: decoder-only dense GQA models, forward only
(a prefill); ``cfg_layers % n_stages == 0``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..models import layers as L
from ..models.model import DTYPE, _block, _embed_in, _layer, cfg_layers
from ..models.sharding import axis_sizes, coordinate, gather_rows


def _stage_forward(cfg: ArchConfig, p_layers: dict, n: int, h, positions):
    """This stage's ``n`` layers on ``h``, cache-less."""
    for i in range(n):
        h, _ = _block(cfg, _layer(p_layers, i), h, positions=positions,
                      cache=None, cache_pos=0)
    return h


def make_pp_prefill_step(cfg: ArchConfig, mesh, n_micro: int = 8):
    """Pipelined prefill: ``step(params, batch)`` with ``batch["tokens"]``
    (B, S), the same on every rank, → the (B, S, vocab) logits on every
    rank.  ``params`` are the model's whole parameters (each rank slices
    its stage's layers); ``mesh`` carries ``stage``, and ``data`` /
    ``model`` dims as the caller likes."""
    if cfg.mla or cfg.n_experts or cfg.ssm or cfg.family == "hybrid" \
            or cfg.first_dense or not cfg.uses_tokens:
        raise ValueError("the pipelined prefill covers the dense GQA "
                         "families")
    sizes = axis_sizes(mesh)
    n_stages = sizes["stage"]
    if cfg_layers(cfg) % n_stages:
        raise ValueError(f"{cfg_layers(cfg)} layers do not split over "
                         f"{n_stages} stages")
    per = cfg_layers(cfg) // n_stages
    stage = mesh.get_local_rank("stage")
    last = n_stages - 1
    grp = mesh.get_group("stage")
    prev = dist.get_global_rank(grp, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(grp, stage + 1) if stage < last else None

    @torch.no_grad()
    def step(params: dict, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        B, S = tokens.shape
        row, D = coordinate(mesh, ("data",) if "data" in sizes else ())
        if B % D:
            raise ValueError(f"batch {B} does not split over data {D}")
        Bl = B // D
        toks = tokens[row * Bl : (row + 1) * Bl]
        if Bl % n_micro:
            raise ValueError(f"local batch {Bl} does not split into "
                             f"{n_micro} microbatches")
        mb = Bl // n_micro
        lp = _slice_layers(params["layers"], stage * per, per)
        positions = torch.arange(S, device=tokens.device,
                                 dtype=torch.int32)[None].expand(mb, S)
        out = None
        pending = []
        for t in range(n_micro + n_stages - 1):
            m = t - stage
            if not 0 <= m < n_micro:
                continue
            if stage == 0:
                h = _embed_in(cfg, params, {"tokens": toks[m * mb:
                                                           (m + 1) * mb]})
            else:
                h = torch.empty(mb, S, cfg.d_model, dtype=DTYPE,
                                device=tokens.device)
                dist.recv(h, src=prev)
            h = _stage_forward(cfg, lp, per, h, positions)
            if stage < last:
                pending.append((dist.isend(h.contiguous(), dst=nxt), h))
                continue
            x = L.norm(h, params["final_norm"], cfg.norm)
            head = params["embed"].T if cfg.tie_embeddings \
                else params["lm_head"]
            logits = x @ head
            if out is None:
                out = logits.new_zeros(n_micro, mb, S, logits.shape[-1])
            out[m] = logits
        for work, _ in pending:
            work.wait()
        if out is None:
            out = torch.zeros(n_micro, mb, S, cfg.vocab, dtype=DTYPE,
                              device=tokens.device)
        if n_stages > 1:
            dist.all_reduce(out, group=grp)
        out = out.reshape(Bl, S, -1)
        return gather_rows(out, mesh, ("data",)) if "data" in sizes else out

    return step


def _slice_layers(tree: dict, start: int, n: int) -> dict:
    return {k: _slice_layers(v, start, n) if isinstance(v, dict)
            else v[start : start + n] for k, v in tree.items()}
