"""The device mesh and the per-cell logical sharding rules — the
reference's ``repro.launch.mesh`` on a torch ``DeviceMesh``.

Mesh dims:
  * ``pod``   — data parallelism across pods (only gradient reductions
    cross pods);
  * ``data``  — in-pod data parallelism and FSDP (parameters' embed dim);
  * ``model`` — heads / mlp / experts / vocab (the expert-parallel MoE
    computes over it; elsewhere the port shards only storage on it,
    ``models/sharding.py``).

``rules_for`` maps the logical axis names of the model code to mesh dims
per (arch × shape) cell:

  train/prefill: batch→(pod,data), embed→data (FSDP), heads/mlp/vocab→model
  decode:        batch→(pod,data), kv_seq→model (the cache's sequence)
  long-context:  batch=1 → sequence/state over (data, model)

A mesh needs its process group started first
(``torch.distributed.init_process_group``; one rank per device); a
group that cannot start raises, and nothing falls back to one process.
On a card the train step is captured with its NCCL collectives
(``launch.train.TrainGraph``), which needs no setting of the group: by
default a collective's wait is a wait of the caller's stream on the
group's.  The capture relies on that default: with
``TORCH_NCCL_BLOCKING_WAIT=1`` a wait would block the host inside it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import devices
from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import schema
from ..models.sharding import MeshRules, axis_names, axis_sizes, distribute
from ..tree import map_tree


def make_mesh(shape: tuple, axes: tuple,
              device: Union[str, torch.device, None] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    process group's ranks, on the card by default (``"cpu"``: gloo
    ranks, as the tests run)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = devices.resolve(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512 ranks, with ``pod``): only
    in a world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def rules_for(cfg: ArchConfig, shape: ShapeConfig, mesh) -> MeshRules:
    """Logical → mesh dim rules for one (arch × shape × mesh) cell."""
    ba = batch_axes(mesh)
    model_size = axis_sizes(mesh)["model"]
    # expert parallelism only when experts divide the model dim; else the
    # experts stay replicated and the expert FFN's hidden dim takes it
    ep = cfg.n_experts > 0 and cfg.n_experts % model_size == 0
    rules = {
        "batch": ba,
        "seq": None,
        "embed": "data" if cfg.fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model" if ep else None,
        "moe_mlp": None if ep else "model",
        "capacity": "data",
        "d_inner": "model",
        "layers": None,
        "kv_seq": None,
    }
    act_over: dict = {}
    if shape.is_decode:
        # the cache (layers, batch, seq, kv_heads, hd) shards its sequence;
        # kv_heads keeps the model dim for parameters only
        rules["kv_seq"] = "model"
        act_over["kv_heads"] = None
        if cfg.decode_layout == "replicated" and shape.global_batch > 1:
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
        if shape.global_batch == 1:
            # nothing to shard on batch: the cache and the state take both
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
            act_over["d_inner"] = ("data", "model")
    return MeshRules(mesh, rules, act_over)


def param_shardings(cfg: ArchConfig, rules: MeshRules) -> dict:
    """A ``NamedSharding`` (spec and DTensor placements) for every
    parameter, in :func:`..models.model.schema`'s tree; mesh extents that
    do not divide a dim are dropped (replicated)."""
    return map_tree(lambda s: rules.sharding_for_shape(s.axes, s.shape),
                    schema(cfg))


def _cache_axes(name: str, nd: int) -> tuple:
    if name in ("k", "v", "c_kv", "k_rope"):
        return ("layers", "batch", "kv_seq") + (None,) * (nd - 3)
    if name == "conv":                  # (L, B, K-1, C): channels last
        return ("layers", "batch", None, "d_inner")
    if name == "ssm":
        if nd == 5:                     # (L, B, Hm, P, N) Mamba2
            return ("layers", "batch", "d_inner", None, None)
        return ("layers", "batch") + (None,) * (nd - 3) + ("d_inner",)
    if name in ("attn_k", "attn_v"):
        return ("layers", "batch", "kv_seq", None, None)
    if name == "attn_pos":
        return ("layers", "batch", None)
    return (None,) * nd


def cache_shardings(cfg: ArchConfig, rules: MeshRules, cache_tree: dict
                    ) -> dict:
    """A ``NamedSharding`` for every leaf of a decode cache tree (tensors,
    or :class:`..models.model.CacheLeaf` s), by leaf name and rank, under
    the activation view of the rules (``kv_seq`` owns the model dim)."""
    act = rules.act()

    def one(name, leaf):
        shape = tuple(leaf.shape)
        return act.sharding_for_shape(_cache_axes(name, len(shape)), shape)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(k, v)
                for k, v in tree.items()}

    return walk(cache_tree)


def shard_tree(tree: dict, shardings: dict) -> dict:
    """Each leaf of ``tree`` (the same values on every rank) as a DTensor
    of its sharding."""
    return map_tree(distribute, tree, shardings)


def init_sharded_params(cfg: ArchConfig, rules: MeshRules, seed: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> dict:
    """:func:`..models.model.init_params`' draw, leaf by leaf, each leaf
    sharded as it is drawn, so a rank never holds more than one leaf
    whole: the same values as the single-device draw."""
    from ..models.model import _init_leaf, _map

    dev = devices.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _map(schema(cfg), lambda path, s: distribute(
        _init_leaf(s.shape, s.init, gen, dev),
        rules.sharding_for_shape(s.axes, s.shape)))
