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


def _norm_spec(cfg, lead):
    s = {"scale": (lead + (cfg.d_model,), "zeros")}
    if cfg.norm == "layernorm":
        s["bias"] = (lead + (cfg.d_model,), "zeros")
    return s


def _attn_specs(cfg, n):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "norm": _norm_spec(cfg, (n,)),
        "wq": ((n, d, H * hd), "normal"),
        "wk": ((n, d, KV * hd), "normal"),
        "wv": ((n, d, KV * hd), "normal"),
        "wo": ((n, H * hd, d), "normal"),
    }
    if cfg.qkv_bias:
        s["bq"] = ((n, H * hd), "zeros")
        s["bk"] = ((n, KV * hd), "zeros")
        s["bv"] = ((n, KV * hd), "zeros")
    return s


def _mla_specs(cfg, n):
    """As the reference's: the attention norm has no layernorm bias."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    r, rd, vh = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.v_head_dim or cfg.hd
    return {
        "norm": {"scale": ((n, d), "zeros")},
        "wq": ((n, d, H * (hd + rd)), "normal"),
        "w_dkv": ((n, d, r + rd), "normal"),
        "kv_norm": {"scale": ((n, r), "zeros")},
        "w_uk": ((n, r, H * hd), "normal"),
        "w_uv": ((n, r, H * vh), "normal"),
        "wo": ((n, H * vh, d), "normal"),
    }


def _ffn_specs(cfg, lead, f):
    d = cfg.d_model
    s = {"w1": (lead + (d, f), "normal"), "w2": (lead + (f, d), "normal")}
    if cfg.mlp == "swiglu":
        s["w3"] = (lead + (d, f), "normal")
    return s


def _mlp_specs(cfg, n):
    return {"norm": _norm_spec(cfg, (n,)), **_ffn_specs(cfg, (n,), cfg.d_ff)}


def _moe_specs(cfg, n):
    d, E = cfg.d_model, cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    s = {"norm": _norm_spec(cfg, (n,)),
         "router": ((n, d, E), "normal"),
         **_ffn_specs(cfg, (n, E), fe)}
    if cfg.n_shared_experts:
        s["shared"] = _ffn_specs(cfg, (n,), fe * cfg.n_shared_experts)
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
    return {
        "norm": {"scale": ((n, d), "zeros")},
        "in_proj": ((n, d, 2 * di), "normal"),
        "conv_w": ((n, di, K), "normal"),
        "conv_b": ((n, di), "zeros"),
        "x_proj": ((n, di, r + 2 * N), "normal"),
        "dt_proj": ((n, r, di), "normal"),
        "dt_bias": ((n, di), "dt_bias"),
        "A_log": ((n, di, N), "a_log"),
        "D": ((n, di), "ones"),
        "out_proj": ((n, di, d), "normal"),
    }


def ssm_heads(cfg: ArchConfig) -> int:
    """Mamba2 heads (the reference's default when the config names none)."""
    return cfg.ssm_heads or max(cfg.d_inner // 64, 1)


def _mamba2_specs(cfg):
    n, d, di, N, K = (cfg.n_layers, cfg.d_model, cfg.d_inner,
                      cfg.ssm_state, cfg.d_conv)
    Hm = ssm_heads(cfg)
    return {
        "norm": {"scale": ((n, d), "zeros")},
        "in_proj": ((n, d, 2 * di + 2 * N + Hm), "normal"),
        "conv_w": ((n, di + 2 * N, K), "normal"),
        "conv_b": ((n, di + 2 * N), "zeros"),
        "dt_bias": ((n, Hm), "dt_bias"),
        "A_log": ((n, Hm), "a_log2"),
        "D": ((n, Hm), "ones"),
        "norm_gated": {"scale": ((n, di), "zeros")},
        "out_proj": ((n, di, d), "normal"),
    }


def _shared_block_specs(cfg):
    """zamba2's one shared attention + MLP block (unstacked; rmsnorm, no
    biases, as the reference's)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    mlp = {"norm": {"scale": ((d,), "zeros")}, **_ffn_specs(cfg, (), cfg.d_ff)}
    return {
        "attn": {"norm": {"scale": ((d,), "zeros")},
                 "wq": ((d, H * hd), "normal"),
                 "wk": ((d, KV * hd), "normal"),
                 "wv": ((d, KV * hd), "normal"),
                 "wo": ((H * hd, d), "normal")},
        "mlp": mlp,
    }


def schema(cfg: ArchConfig) -> Dict[str, object]:
    """Nested dict of ``(shape, init)`` leaves — the reference's schema.
    Inits: ``"normal"`` (scaled by 1/sqrt(shape[-2])), ``"zeros"``,
    ``"ones"``, and the SSMs' f32 ``"a_log"`` / ``"a_log2"`` /
    ``"dt_bias"`` (:func:`leaf_dtype`).  ``embed`` only for a token
    model; ``layers`` stacks the Mamba1 or Mamba2 blocks, or every
    transformer layer but the ``first_dense`` leading ones, which
    ``dense0`` stacks with a dense MLP; ``shared`` is the hybrid's one
    attention block."""
    d, V = cfg.d_model, cfg.vocab
    s: Dict[str, object] = {}
    if cfg.uses_tokens:
        s["embed"] = ((V, d), "normal")
    if cfg.ssm == "mamba1":
        s["layers"] = _mamba1_specs(cfg)
    elif cfg.family == "hybrid":
        s["layers"] = _mamba2_specs(cfg)
        s["shared"] = _shared_block_specs(cfg)
    else:
        s["layers"] = _block_specs(cfg, cfg_layers(cfg), bool(cfg.n_experts))
        if cfg.first_dense:
            s["dense0"] = _block_specs(cfg, cfg.first_dense, False)
    s["final_norm"] = _norm_spec(cfg, ())
    if not cfg.tie_embeddings:
        s["lm_head"] = ((d, V), "normal")
    return s


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
    return _map(schema(cfg), lambda path, spec: _init_leaf(*spec, gen, dev))


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
        if tuple(arr.shape) != tuple(spec[0]):
            raise ValueError(f"parameter {'.'.join(path)}: shape "
                             f"{arr.shape} != {spec[0]}")
        dtype = leaf_dtype(spec[1])
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
    balance loss, or None (an MLP, or a single token)."""
    attn = L.mla_block if cfg.mla else L.gqa_block
    x = x + attn(x, p["attn"], cfg, positions=positions, cache=cache,
                 cache_pos=cache_pos)
    if "moe" in p:
        y, aux = L.moe_block(x, p["moe"], cfg)
        return x + y, aux
    return x + L.mlp_block(x, p["mlp"], cfg), None


def _remat(cfg: ArchConfig, cache) -> bool:
    """Checkpoint each layer: ``cfg.remat``, no cache, autograd on — as
    the reference wraps its scan body in ``jax.checkpoint`` for a
    forward without a cache (its ``jax.grad`` is what records)."""
    return cfg.remat and cache is None and torch.is_grad_enabled()


def _call(remat: bool, fn, x):
    """``fn(x)``; under ``remat`` through ``torch.utils.checkpoint``
    (non-reentrant), so the layer keeps only its input for the backward
    and recomputes the rest there.  ``fn`` is a ``functools.partial``,
    bound before the recompute runs."""
    if remat:
        return checkpoint(fn, x, use_reentrant=False)
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
            x, a = _call(remat, functools.partial(
                _block, cfg, _layer(lp, i), positions=positions, cache=c,
                cache_pos=cache_pos), x)
            if a is not None:
                aux = a if aux is None else aux + a
    return x, aux


def _mamba1_layer(cfg, p, st, x):
    return x + L.mamba1_mix(L.norm(x, p["norm"], cfg.norm), p, cfg, st)


def _forward_mamba(cfg, params, x, cache):
    """Mamba1: a residual mixer a layer, each with its layer's state."""
    remat = _remat(cfg, cache)
    for i in range(cfg.n_layers):
        st = None if cache is None else _layer(cache["layers"], i)
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
    x = x + L.mamba2_mix(L.norm(x, p["norm"], cfg.norm), p, cfg, st)
    if shared is not None:
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
        x = _call(remat, functools.partial(
            _hybrid_layer, cfg, _layer(params["layers"], i), st,
            params["shared"] if i in apps else None, c, positions), x)
    return x


def _embed_in(cfg, params, batch):
    """Token ids through the embedding, or a frontend model's ``embeds``
    (B, S, d) as bf16."""
    if cfg.uses_tokens:
        return params["embed"][batch["tokens"].long()]
    return batch["embeds"].to(DTYPE)


def forward_with_aux(cfg: ArchConfig, params: dict, batch: dict,
                     cache: Optional[dict] = None):
    """:func:`forward`, and the MoE balance loss summed over the stacked
    layers (an f32 zero for every other family, as the reference's):
    ``(logits, cache, aux)``, the reference's ``forward``.  Only
    :func:`lm_loss` reads ``aux``, so :func:`forward`, which every
    serving caller uses, keeps its pair."""
    if cache is not None and not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode "
                         "step, so its forward takes no cache")
    x = _embed_in(cfg, params, batch)
    B, S = x.shape[:2]
    cache_pos = 0 if cache is None else int(batch["cache_pos"])
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
    x = L.norm(x, params["final_norm"], cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, cache, aux


def forward(cfg: ArchConfig, params: dict, batch: dict,
            cache: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """``batch``: ``tokens`` (B, S) int, or ``embeds`` (B, S, d) for a
    frontend model; with a cache also ``cache_pos`` (int, the position of
    the first token).  Without a cache the tokens attend to each other
    from position 0 (causally, or both ways for an encoder) and nothing
    is kept; with one their KV (or recurrent state) is written into it in
    place.  Returns ``(logits (B, S, vocab) bf16, cache)``."""
    logits, cache, _ = forward_with_aux(cfg, params, batch, cache)
    return logits, cache


def lm_loss(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """The training loss, as the reference's: the mean cross-entropy of
    the f32 ``log_softmax`` of the logits against ``batch["labels"]``
    (B, S) — for a causal model the logit at position t against the
    label at t + 1, so ``labels`` are aligned with the positions (pass
    the tokens themselves) — plus ``0.01 * aux``.  f32 scalar."""
    logits, _, aux = forward_with_aux(cfg, params, batch)
    labels = batch["labels"].long()
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = -lp.gather(-1, labels[..., None])[..., 0].mean()
    return loss + 0.01 * aux


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
