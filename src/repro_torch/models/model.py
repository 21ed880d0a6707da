"""Every model family of the reference — the token decoders (dense GQA,
MLA, MoE with shared experts and leading dense layers), Mamba1
(falcon-mamba), the Mamba2 hybrid with its one shared attention block
(zamba2), the encoder-only model (hubert) and the embeds-fed frontends
(llava): parameter layout, seeded init, conversion from the reference's
parameters, forward (with or without a cache), the training loss and
the decode-time cache.

Parameters are a nested dict of tensors in the reference's layout, with
per-layer weights stacked on a leading ``layers`` axis, so
:func:`params_from_jax` is a leaf-by-leaf conversion.  Forward runs the
layer loop in Python (PyTorch is eager; the reference scans), each layer
under activation checkpointing when the config asks for remat and
autograd records.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import devices
from ..configs.base import ArchConfig
from . import layers as L
from .sharding import gathered, local_cache, logical

DTYPE = torch.bfloat16
KV_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
# init kinds whose leaves stay f32, as the reference's abstract_params says
F32_INITS = ("a_log", "a_log2", "dt_bias")

Device = Union[str, torch.device, None]


def leaf_dtype(init: str) -> torch.dtype:
    """A parameter's dtype from its init kind: the SSMs' ``A_log`` and
    ``dt_bias`` are f32, every other leaf bf16."""
    return torch.float32 if init in F32_INITS else DTYPE


def cfg_layers(cfg: ArchConfig) -> int:
    """Stacked-layer count: every layer but the leading dense ones."""
    return cfg.n_layers - cfg.first_dense


class Spec(NamedTuple):
    """One parameter: its shape, init kind and logical axes (one name
    or None per dim), the reference's ``Spec``."""

    shape: tuple
    init: str
    axes: tuple


def _spec(shape, init, axes) -> Spec:
    assert len(shape) == len(axes), (shape, axes)
    return Spec(tuple(shape), init, tuple(axes))


def _norm_spec(cfg, lead, lead_axes):
    s = {"scale": _spec(lead + (cfg.d_model,), "zeros", lead_axes + (None,))}
    if cfg.norm == "layernorm":
        s["bias"] = _spec(lead + (cfg.d_model,), "zeros", lead_axes + (None,))
    return s


def _attn_specs(cfg, n):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    A = ("layers",)
    s = {
        "norm": _norm_spec(cfg, (n,), A),
        "wq": _spec((n, d, H * hd), "normal", A + ("embed", "heads")),
        "wk": _spec((n, d, KV * hd), "normal", A + ("embed", "kv_heads")),
        "wv": _spec((n, d, KV * hd), "normal", A + ("embed", "kv_heads")),
        "wo": _spec((n, H * hd, d), "normal", A + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = _spec((n, H * hd), "zeros", A + ("heads",))
        s["bk"] = _spec((n, KV * hd), "zeros", A + ("kv_heads",))
        s["bv"] = _spec((n, KV * hd), "zeros", A + ("kv_heads",))
    return s


def _mla_specs(cfg, n):
    """As the reference's: the attention norm has no layernorm bias."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    r, rd, vh = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.v_head_dim or cfg.hd
    A = ("layers",)
    return {
        "norm": {"scale": _spec((n, d), "zeros", A + (None,))},
        "wq": _spec((n, d, H * (hd + rd)), "normal", A + ("embed", "heads")),
        "w_dkv": _spec((n, d, r + rd), "normal", A + ("embed", None)),
        "kv_norm": {"scale": _spec((n, r), "zeros", A + (None,))},
        "w_uk": _spec((n, r, H * hd), "normal", A + (None, "heads")),
        "w_uv": _spec((n, r, H * vh), "normal", A + (None, "heads")),
        "wo": _spec((n, H * vh, d), "normal", A + ("heads", "embed")),
    }


def _ffn_specs(cfg, lead, lead_axes, f, hidden="mlp"):
    d = cfg.d_model
    s = {"w1": _spec(lead + (d, f), "normal", lead_axes + ("embed", hidden)),
         "w2": _spec(lead + (f, d), "normal", lead_axes + (hidden, "embed"))}
    if cfg.mlp == "swiglu":
        s["w3"] = _spec(lead + (d, f), "normal",
                        lead_axes + ("embed", hidden))
    return s


def _mlp_specs(cfg, n):
    return {"norm": _norm_spec(cfg, (n,), ("layers",)),
            **_ffn_specs(cfg, (n,), ("layers",), cfg.d_ff)}


def _moe_specs(cfg, n):
    d, E = cfg.d_model, cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    A = ("layers",)
    s = {"norm": _norm_spec(cfg, (n,), A),
         "router": _spec((n, d, E), "normal", A + ("embed", None)),
         **_ffn_specs(cfg, (n, E), A + ("experts",), fe, "moe_mlp")}
    if cfg.n_shared_experts:
        s["shared"] = _ffn_specs(cfg, (n,), A, fe * cfg.n_shared_experts)
    return s


def _block_specs(cfg, n, moe: bool):
    block = {"attn": _mla_specs(cfg, n) if cfg.mla else _attn_specs(cfg, n)}
    if moe:
        block["moe"] = _moe_specs(cfg, n)
    else:
        block["mlp"] = _mlp_specs(cfg, n)
    return block


def _mamba1_specs(cfg):
    n, d, di, N, K = (cfg.n_layers, cfg.d_model, cfg.d_inner,
                      cfg.ssm_state, cfg.d_conv)
    r = max(d // 16, 1)
    A = ("layers",)
    return {
        "norm": {"scale": _spec((n, d), "zeros", A + (None,))},
        "in_proj": _spec((n, d, 2 * di), "normal", A + ("embed", "d_inner")),
        "conv_w": _spec((n, di, K), "normal", A + ("d_inner", None)),
        "conv_b": _spec((n, di), "zeros", A + ("d_inner",)),
        "x_proj": _spec((n, di, r + 2 * N), "normal", A + ("d_inner", None)),
        "dt_proj": _spec((n, r, di), "normal", A + (None, "d_inner")),
        "dt_bias": _spec((n, di), "dt_bias", A + ("d_inner",)),
        "A_log": _spec((n, di, N), "a_log", A + ("d_inner", None)),
        "D": _spec((n, di), "ones", A + ("d_inner",)),
        "out_proj": _spec((n, di, d), "normal", A + ("d_inner", "embed")),
    }


def ssm_heads(cfg: ArchConfig) -> int:
    """Mamba2 heads (the reference's default when the config names none)."""
    return cfg.ssm_heads or max(cfg.d_inner // 64, 1)


def _mamba2_specs(cfg):
    n, d, di, N, K = (cfg.n_layers, cfg.d_model, cfg.d_inner,
                      cfg.ssm_state, cfg.d_conv)
    Hm = ssm_heads(cfg)
    A = ("layers",)
    return {
        "norm": {"scale": _spec((n, d), "zeros", A + (None,))},
        "in_proj": _spec((n, d, 2 * di + 2 * N + Hm), "normal",
                         A + ("embed", "d_inner")),
        "conv_w": _spec((n, di + 2 * N, K), "normal", A + ("d_inner", None)),
        "conv_b": _spec((n, di + 2 * N), "zeros", A + ("d_inner",)),
        "dt_bias": _spec((n, Hm), "dt_bias", A + (None,)),
        "A_log": _spec((n, Hm), "a_log2", A + (None,)),
        "D": _spec((n, Hm), "ones", A + (None,)),
        "norm_gated": {"scale": _spec((n, di), "zeros", A + ("d_inner",))},
        "out_proj": _spec((n, di, d), "normal", A + ("d_inner", "embed")),
    }


def _shared_block_specs(cfg):
    """zamba2's one shared attention + MLP block (unstacked; rmsnorm, no
    biases, as the reference's)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    norm = lambda: {"scale": _spec((d,), "zeros", (None,))}  # noqa: E731
    return {
        "attn": {"norm": norm(),
                 "wq": _spec((d, H * hd), "normal", ("embed", "heads")),
                 "wk": _spec((d, KV * hd), "normal", ("embed", "kv_heads")),
                 "wv": _spec((d, KV * hd), "normal", ("embed", "kv_heads")),
                 "wo": _spec((H * hd, d), "normal", ("heads", "embed"))},
        "mlp": {"norm": norm(), **_ffn_specs(cfg, (), (), cfg.d_ff)},
    }


def schema(cfg: ArchConfig) -> Dict[str, object]:
    """Nested dict of :class:`Spec` leaves — the reference's schema:
    shape, init and logical axes.  Inits: ``"normal"`` (scaled by
    1/sqrt(shape[-2])), ``"zeros"``, ``"ones"``, and the SSMs' f32
    ``"a_log"`` / ``"a_log2"`` / ``"dt_bias"`` (:func:`leaf_dtype`).
    ``embed`` only for a token model; ``layers`` stacks the Mamba1 or
    Mamba2 blocks, or every transformer layer but the ``first_dense``
    leading ones, which ``dense0`` stacks with a dense MLP; ``shared`` is
    the hybrid's one attention block."""
    d, V = cfg.d_model, cfg.vocab
    s: Dict[str, object] = {}
    if cfg.uses_tokens:
        v_ax = "vocab" if cfg.embed_vocab_shard else None
        s["embed"] = _spec((V, d), "normal", (v_ax, "embed"))
    if cfg.ssm == "mamba1":
        s["layers"] = _mamba1_specs(cfg)
    elif cfg.family == "hybrid":
        s["layers"] = _mamba2_specs(cfg)
        s["shared"] = _shared_block_specs(cfg)
    else:
        s["layers"] = _block_specs(cfg, cfg_layers(cfg), bool(cfg.n_experts))
        if cfg.first_dense:
            s["dense0"] = _block_specs(cfg, cfg.first_dense, False)
    s["final_norm"] = _norm_spec(cfg, (), ())
    if not cfg.tie_embeddings:
        s["lm_head"] = _spec((d, V), "normal", ("embed", "vocab"))
    return s


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter, in :func:`schema`'s tree."""
    return _map(schema(cfg), lambda path, spec: spec.axes)


def abstract_params(cfg: ArchConfig) -> dict:
    """Every parameter as a tensor on the ``meta`` device: shapes and
    dtypes, nothing allocated (the reference's ``abstract_params``)."""
    return _map(schema(cfg), lambda path, spec: torch.empty(
        spec.shape, dtype=leaf_dtype(spec.init), device="meta"))


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _init_leaf(shape, init, gen, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=DTYPE, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=DTYPE, device=dev)
    if init == "a_log":             # mamba1: A = -(1..N) per channel
        a = torch.arange(1, shape[-1] + 1, **f32)
        return torch.log(a).expand(shape).contiguous()
    if init == "a_log2":            # mamba2: one A a head, in [1, 16)
        u = torch.rand(shape, generator=gen, **f32)
        return torch.log(u.mul_(15.0).add_(1.0))
    if init == "dt_bias":           # softplus^-1 of dt in [1e-3, 0.1)
        u = torch.rand(shape, generator=gen, **f32)
        lo, hi = np.log(1e-3), np.log(0.1)
        return torch.log(torch.expm1(torch.exp(u.mul_(hi - lo).add_(lo))))
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, **f32)
    return w.mul_(1.0 / np.sqrt(fan_in)).to(DTYPE)


def init_params(cfg: ArchConfig, seed: int = 0, device: Device = None) -> dict:
    """Random parameters from ``seed`` on ``device`` (default: the card),
    drawn leaf by leaf by a ``torch.Generator`` on that device.  Weights
    are normal with std 1/sqrt(fan_in), norm scales and biases zero, the
    SSMs' ``D`` one, all bf16; ``A_log`` (log 1..N, or log of a uniform
    draw in [1, 16) a head) and ``dt_bias`` (softplus^-1 of a log-uniform
    dt in [1e-3, 0.1)) f32, as the reference draws them."""
    dev = devices.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _map(schema(cfg), lambda path, spec: _init_leaf(
        spec.shape, spec.init, gen, dev))


def params_from_jax(cfg: ArchConfig, tree: dict, device: Device = None) -> dict:
    """Convert the reference's ``init_params`` output, given as a nested
    dict of numpy arrays, into the port's parameters on ``device``.
    Shapes are checked against :func:`schema`; bf16 arrays are moved bit
    for bit, and the f32 leaves (:data:`F32_INITS`) stay f32."""
    dev = devices.resolve(device)

    def leaf(path, spec):
        node = tree
        for k in path:
            if k not in node:
                raise KeyError(f"parameter {'.'.join(path)} missing")
            node = node[k]
        arr = np.asarray(node)
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"parameter {'.'.join(path)}: shape "
                             f"{arr.shape} != {spec.shape}")
        dtype = leaf_dtype(spec.init)
        if dtype == DTYPE and arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype)
        return t.to(dev)

    return _map(schema(cfg), leaf)


class CacheLeaf(NamedTuple):
    """One cache tensor: its shape, dtype and fill value."""

    shape: tuple
    dtype: torch.dtype
    fill: int = 0


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
    """The decode-time cache as nested :class:`CacheLeaf` s, nothing
    allocated; KV leaves in ``dtype`` (default ``cfg.kv_dtype``).

    * token decoders: ``layers`` holds the stacked layers' ``k``/``v``
      (n, batch, max_seq, kv_heads, hd), or for MLA their ``c_kv`` latent
      (n, batch, max_seq, kv_lora_rank) and ``k_rope`` (n, batch,
      max_seq, 1, qk_rope_dim); ``dense0`` the same for the leading dense
      layers;
    * Mamba1: ``layers``' ``conv`` (n, batch, K-1, d_inner) in ``dtype``
      and ``ssm`` (n, batch, d_inner, N) f32;
    * the hybrid: ``layers``' ``conv`` (…, d_inner + 2N) and ``ssm`` (n,
      batch, heads, P, N) f32, and per shared-block application its
      rolling window of W = min(window or max_seq, max_seq) slots:
      ``attn_k`` / ``attn_v`` (apps, batch, W, kv_heads, hd) and
      ``attn_pos`` (apps, batch, W) int32, filled with -2 * window (a
      position every window excludes)."""
    dtype = dtype or KV_DTYPES[cfg.kv_dtype]
    f32 = torch.float32
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    if cfg.ssm == "mamba1":
        return {"layers": {
            "conv": CacheLeaf((cfg.n_layers, batch, K - 1, di), dtype),
            "ssm": CacheLeaf((cfg.n_layers, batch, di, N), f32)}}
    if cfg.family == "hybrid":
        Hm = ssm_heads(cfg)
        W = min(cfg.window or max_seq, max_seq)
        apps = cfg.n_layers // cfg.attn_every
        kv = CacheLeaf((apps, batch, W, cfg.n_kv_heads, cfg.hd), dtype)
        return {
            "layers": {
                "conv": CacheLeaf((cfg.n_layers, batch, K - 1, di + 2 * N),
                                  dtype),
                "ssm": CacheLeaf((cfg.n_layers, batch, Hm, di // Hm, N), f32)},
            "attn_k": kv, "attn_v": kv,
            "attn_pos": CacheLeaf((apps, batch, W), torch.int32,
                                  -2 * (cfg.window or 1)),
        }

    def kinds(n):
        if cfg.mla:
            return {"c_kv": CacheLeaf((n, batch, max_seq, cfg.kv_lora_rank),
                                      dtype),
                    "k_rope": CacheLeaf((n, batch, max_seq, 1,
                                         cfg.qk_rope_dim), dtype)}
        leaf = CacheLeaf((n, batch, max_seq, cfg.n_kv_heads, cfg.hd), dtype)
        return {"k": leaf, "v": leaf}

    spec = {"layers": kinds(cfg_layers(cfg))}
    if cfg.first_dense:
        spec["dense0"] = kinds(cfg.first_dense)
    return spec


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: Device = None, dtype: Optional[torch.dtype] = None
               ) -> dict:
    """The decode-time cache of :func:`cache_spec` on ``device``, each
    leaf filled with its fill value."""
    dev = devices.resolve(device)

    def alloc(leaf):
        if isinstance(leaf, dict):
            return {k: alloc(v) for k, v in leaf.items()}
        return torch.full(leaf.shape, leaf.fill, dtype=leaf.dtype, device=dev)

    return alloc(cache_spec(cfg, batch, max_seq, dtype))


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _block(cfg, p, x, *, positions, cache, cache_pos):
    """One decoder (or encoder) layer: MLA or GQA attention, then the MoE
    or the MLP, each as a residual.  Returns ``(x, aux)``: the MoE's
    balance loss, or None (an MLP, or a single token).  On a mesh the
    layer gathers its parameters here (the MoE its own, which the
    expert-parallel path keeps sharded over ``model``)."""
    attn = L.mla_block if cfg.mla else L.gqa_block
    x = x + attn(x, gathered(p["attn"]), cfg, positions=positions,
                 cache=cache, cache_pos=cache_pos)
    if "moe" in p:
        y, aux = L.moe_block(x, p["moe"], cfg)
    else:
        y, aux = L.mlp_block(x, gathered(p["mlp"]), cfg), None
    return logical(x + y, "batch", "seq", "embed"), aux


def _remat(cfg: ArchConfig, cache) -> bool:
    """Checkpoint each layer: ``cfg.remat``, no cache, autograd on — as
    the reference wraps its scan body in ``jax.checkpoint`` for a
    forward without a cache (its ``jax.grad`` is what records)."""
    return cfg.remat and cache is None and torch.is_grad_enabled()


def _call(remat: bool, fn, x):
    """``fn(x)``; under ``remat`` through ``torch.utils.checkpoint``
    (non-reentrant), so the layer keeps only its input for the backward
    and recomputes the rest there.  ``fn`` is a ``functools.partial``,
    bound before the recompute runs.  No layer draws a random number, so
    the RNG state is not stashed for the recompute: reading the card's
    generator state would fail inside a CUDA graph capture."""
    if remat:
        return checkpoint(fn, x, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(x)


def _forward_transformer(cfg, params, x, positions, cache, cache_pos):
    """The ``dense0`` layers, then the stacked ones.  Returns ``(x,
    aux)``: the MoE layers' balance losses summed in layer order, or None
    if there are none.  Only stacked layers have a MoE (``dense0`` holds
    dense MLPs; the reference's ``dense0`` loop drops their zero aux)."""
    remat = _remat(cfg, cache)
    aux = None
    for part, n in (("dense0", cfg.first_dense), ("layers", cfg_layers(cfg))):
        if part not in params:
            continue
        lp = params[part]
        for i in range(n):
            c = None if cache is None else {k: v[i] for k, v in
                                            cache[part].items()}
            with local_cache(c) as c:
                x, a = _call(remat, functools.partial(
                    _block, cfg, _layer(lp, i), positions=positions,
                    cache=c, cache_pos=cache_pos), x)
            if a is not None:
                aux = a if aux is None else aux + a
    return x, aux


def _mamba1_layer(cfg, p, st, x):
    p = gathered(p)
    return x + L.mamba1_mix(L.norm(x, p["norm"], cfg.norm), p, cfg, st)


def _forward_mamba(cfg, params, x, cache):
    """Mamba1: a residual mixer a layer, each with its layer's state."""
    remat = _remat(cfg, cache)
    for i in range(cfg.n_layers):
        st = None if cache is None else _layer(cache["layers"], i)
        with local_cache(st) as st:
            x = _call(remat, functools.partial(
                _mamba1_layer, cfg, _layer(params["layers"], i), st), x)
    return x


def shared_applications(cfg: ArchConfig):
    """The hybrid's shared-block applications as ``(layer, app)`` pairs:
    after Mamba2 layer ``i`` where ``i % attn_every == 0`` and ``i //
    attn_every`` < ``n_layers // attn_every``, with cache slot ``app = i
    // attn_every`` (zamba2: 13 over 81 layers, at 0, 6, …, 72)."""
    every = cfg.attn_every
    apps = cfg.n_layers // every
    return [(i, i // every) for i in range(cfg.n_layers)
            if i % every == 0 and i // every < apps]


def _hybrid_layer(cfg, p, st, shared, c, positions, x):
    """One Mamba2 layer, then (``shared`` not None) the shared attention
    + MLP block over its application's cache ``c``."""
    p = gathered(p)
    x = x + L.mamba2_mix(L.norm(x, p["norm"], cfg.norm), p, cfg, st)
    if shared is not None:
        shared = gathered(shared)
        x = x + L.gqa_block(x, shared["attn"], cfg, positions=positions,
                            cache=c, window=cfg.window)
        x = x + L.mlp_block(x, shared["mlp"], cfg)
    return x


def _forward_hybrid(cfg, params, x, positions, cache):
    """zamba2: the Mamba2 layers, and after each application layer the one
    shared attention + MLP block, windowed, over its own application's
    rolling cache."""
    remat = _remat(cfg, cache)
    apps = dict(shared_applications(cfg))
    for i in range(cfg.n_layers):
        st = None if cache is None else _layer(cache["layers"], i)
        c = None
        if cache is not None and i in apps:
            a = apps[i]
            c = {"k": cache["attn_k"][a], "v": cache["attn_v"][a],
                 "kpos": cache["attn_pos"][a]}
        with local_cache(st) as st, local_cache(c) as c:
            x = _call(remat, functools.partial(
                _hybrid_layer, cfg, _layer(params["layers"], i), st,
                params["shared"] if i in apps else None, c, positions), x)
    return x


def _embed_in(cfg, params, batch):
    """Token ids through the embedding, or a frontend model's ``embeds``
    (B, S, d) as bf16."""
    if cfg.uses_tokens:
        x = params["embed"][batch["tokens"].long()]
    else:
        x = batch["embeds"].to(DTYPE)
    return logical(x, "batch", "seq", "embed")


def cache_capacity(cache: dict) -> Optional[int]:
    """Slots of a decode cache's linear KV caches (GQA ``k`` or MLA
    ``c_kv``), or None for a cache without one: the Mamba states and the
    hybrid's rolling window take any position."""
    for part in ("layers", "dense0"):
        for kind in ("k", "c_kv"):
            if kind in cache.get(part, {}):
                return cache[part][kind].shape[2]
    return None


def _cache_position(pos, cache: dict, x: torch.Tensor, S: int):
    """The decode position in one of two forms.  A 0-d integer tensor on
    the model's device is the reference's traced ``jnp.int32`` scalar:
    returned as an int32 tensor and never read on the host (no sync, so
    a CUDA graph can capture the step); the cache writes index with it.
    Anything else (an int, or a concrete CPU scalar beside a model on
    another device, as the dry run passes) is read on the host, and a
    position whose tokens pass the cache's capacity raises here, before
    any write.  (The reference's ``dynamic_update_slice`` clamps such a
    write silently; on the device form the serving engine checks its
    position on the host before the step.)"""
    if isinstance(pos, torch.Tensor) and pos.device == x.device:
        if pos.dim() != 0 or pos.is_floating_point() \
                or pos.dtype == torch.bool:
            raise TypeError(f"cache_pos must be a 0-d integer tensor, got "
                            f"{pos.dtype} of shape {tuple(pos.shape)}")
        return pos.to(torch.int32)
    pos = int(pos)
    cap = cache_capacity(cache)
    if pos < 0 or (cap is not None and pos + S > cap):
        raise ValueError(f"cache_pos {pos} with {S} tokens does not fit "
                         f"the cache's {cap} slots")
    return pos


def forward_with_aux(cfg: ArchConfig, params: dict, batch: dict,
                     cache: Optional[dict] = None):
    """:func:`forward`, and the MoE balance loss summed over the stacked
    layers (an f32 zero for every other family, as the reference's):
    ``(logits, cache, aux)``, the reference's ``forward``.  Only
    :func:`lm_loss` reads ``aux``, so :func:`forward`, which every
    serving caller uses, keeps its pair.  On a mesh (rules installed by a
    step builder) ``batch`` holds this rank's rows, ``params`` and the
    cache may be DTensors, and the logits are this rank's rows."""
    if cache is not None and not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                         "step, so its forward takes no cache")
    top = gathered({k: params[k] for k in ("embed", "final_norm", "lm_head")
                    if k in params})
    x = _embed_in(cfg, top, batch)
    B, S = x.shape[:2]
    cache_pos = 0 if cache is None else _cache_position(batch["cache_pos"],
                                                        cache, x, S)
    positions = (cache_pos + torch.arange(S, device=x.device,
                                          dtype=torch.int32))[None].expand(B, S)
    aux = None
    if cfg.ssm == "mamba1":
        x = _forward_mamba(cfg, params, x, cache)
    elif cfg.family == "hybrid":
        x = _forward_hybrid(cfg, params, x, positions, cache)
    else:
        x, aux = _forward_transformer(cfg, params, x, positions, cache,
                                      cache_pos)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.norm(x, top["final_norm"], cfg.norm)
    head = top["embed"].T if cfg.tie_embeddings else top["lm_head"]
    return logical(x @ head, "batch", "seq", "vocab"), cache, aux


def forward(cfg: ArchConfig, params: dict, batch: dict,
            cache: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """``batch``: ``tokens`` (B, S) int, or ``embeds`` (B, S, d) for a
    frontend model; with a cache also ``cache_pos``, the position of the
    first token: an int, or a 0-d integer tensor on the model's device
    that nothing reads on the host (see :func:`_cache_position`).
    Without a cache the tokens attend to each other from position 0
    (causally, or both ways for an encoder) and nothing is kept; with one
    their KV (or recurrent state) is written into it in place.  Returns
    ``(logits (B, S, vocab) bf16, cache)``."""
    logits, cache, _ = forward_with_aux(cfg, params, batch, cache)
    return logits, cache


def lm_loss_terms(cfg: ArchConfig, params: dict, batch: dict):
    """``(ce, aux)``: the mean cross-entropy of the f32 ``log_softmax``
    of the logits against ``batch["labels"]`` (B, S) — for a causal model
    the logit at position t against the label at t + 1, so ``labels`` are
    aligned with the positions (pass the tokens themselves) — over the
    rows given, and the MoE balance loss (f32 scalars)."""
    logits, _, aux = forward_with_aux(cfg, params, batch)
    labels = batch["labels"].long()
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, labels[..., None])[..., 0].mean(), aux


def lm_loss(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """The training loss, as the reference's: :func:`lm_loss_terms`'
    ``ce + 0.01 * aux``.  f32 scalar."""
    ce, aux = lm_loss_terms(cfg, params, batch)
    return ce + 0.01 * aux


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            max_seq: Optional[int] = None) -> torch.Tensor:
    """The whole prompt's logits without autograd, as the reference's
    ``prefill``: a forward without a cache (``max_seq`` is unused there
    too)."""
    with torch.no_grad():
        return forward(cfg, params, batch)[0]


def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One forward over ``batch``'s tokens (or embeds) at
    ``batch["cache_pos"]`` (a prompt or a single token) with the cache →
    ``(logits, cache)``, without autograd.  An encoder-only model has no
    decode step: :func:`forward` runs it without a cache, and
    :func:`lm_loss` trains it."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                         "step; forward(cfg, params, batch) runs it "
                         "without a cache")
    with torch.no_grad():
        return forward(cfg, params, batch, cache)
