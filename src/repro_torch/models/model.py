"""Token decoders (dense GQA, MLA, MoE with shared experts and leading
dense layers): parameter layout, seeded init, conversion from the
reference's parameters, forward (prefill and decode) and the KV cache.

Parameters are a nested dict of tensors in the reference's layout, with
per-layer weights stacked on a leading ``layers`` axis, so
:func:`params_from_jax` is a leaf-by-leaf conversion.  Forward runs the
layer loop in Python (PyTorch is eager; the reference scans).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import devices
from ..configs.base import ArchConfig
from . import layers as L

DTYPE = torch.bfloat16
KV_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}

Device = Union[str, torch.device, None]


def check_ported(cfg: ArchConfig):
    """Raise ``NotImplementedError`` for a family the port does not serve
    yet: SSM, hybrid, encoder-only and non-token (vision / audio
    frontend) models.  Dense GQA, MLA and MoE token decoders pass."""
    if (cfg.ssm or cfg.family in ("ssm", "hybrid") or not cfg.causal
            or not cfg.uses_tokens):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP.md Queue 1 lists what is left)")


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


def schema(cfg: ArchConfig) -> Dict[str, object]:
    """Nested dict of ``(shape, init)`` leaves: ``"normal"`` (scaled by
    1/sqrt(shape[-2])) or ``"zeros"`` — the reference's schema for the
    token decoders: ``layers`` stacks every layer but the ``first_dense``
    leading ones, which ``dense0`` stacks with a dense MLP."""
    check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab
    s: Dict[str, object] = {
        "embed": ((V, d), "normal"),
        "layers": _block_specs(cfg, cfg_layers(cfg), bool(cfg.n_experts)),
    }
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


def init_params(cfg: ArchConfig, seed: int = 0, device: Device = None) -> dict:
    """Random parameters from ``seed`` on ``device`` (default: the card),
    drawn by a ``torch.Generator`` on that device.  Weights are normal
    with std 1/sqrt(fan_in), norm scales and biases zero, all bf16."""
    dev = devices.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(path, spec):
        shape, init = spec
        if init == "zeros":
            return torch.zeros(shape, dtype=DTYPE, device=dev)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(1.0 / np.sqrt(fan_in)).to(DTYPE)

    return _map(schema(cfg), leaf)


def params_from_jax(cfg: ArchConfig, tree: dict, device: Device = None) -> dict:
    """Convert the reference's ``init_params`` output, given as a nested
    dict of numpy arrays, into the port's parameters on ``device``.
    Shapes are checked against :func:`schema`; bf16 arrays are moved bit
    for bit."""
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
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(DTYPE)
        return t.to(dev)

    return _map(schema(cfg), leaf)


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int
               ) -> Dict[str, Dict[str, tuple]]:
    """Shapes of the decode-time cache, nothing allocated: ``layers``
    holds the stacked layers' ``k``/``v`` (n, batch, max_seq, kv_heads,
    hd), or for MLA their ``c_kv`` latent (n, batch, max_seq,
    kv_lora_rank) and ``k_rope`` (n, batch, max_seq, 1, qk_rope_dim);
    ``dense0`` the same for the leading dense layers."""
    check_ported(cfg)

    def kinds(n):
        if cfg.mla:
            return {"c_kv": (n, batch, max_seq, cfg.kv_lora_rank),
                    "k_rope": (n, batch, max_seq, 1, cfg.qk_rope_dim)}
        shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"k": shape, "v": shape}

    spec = {"layers": kinds(cfg_layers(cfg))}
    if cfg.first_dense:
        spec["dense0"] = kinds(cfg.first_dense)
    return spec


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: Device = None, dtype: Optional[torch.dtype] = None
               ) -> dict:
    """Zeroed decode-time cache of :func:`cache_spec`'s shapes in
    ``cfg.kv_dtype`` (bf16 or fp8-e4m3) on ``device``."""
    dev = devices.resolve(device)
    dtype = dtype or KV_DTYPES[cfg.kv_dtype]
    return {part: {kind: torch.zeros(shape, dtype=dtype, device=dev)
                   for kind, shape in kinds.items()}
            for part, kinds in cache_spec(cfg, batch, max_seq).items()}


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _block(cfg, p, x, *, positions, cache, cache_pos):
    """One decoder layer: MLA or GQA attention, then the MoE or the MLP,
    each as a residual."""
    attn = L.mla_block if cfg.mla else L.gqa_block
    x = x + attn(x, p["attn"], cfg, positions=positions, cache=cache,
                 cache_pos=cache_pos)
    if "moe" in p:
        return x + L.moe_block(x, p["moe"], cfg)
    return x + L.mlp_block(x, p["mlp"], cfg)


def forward(cfg: ArchConfig, params: dict, batch: dict,
            cache: dict) -> Tuple[torch.Tensor, dict]:
    """``batch``: ``tokens`` (B, S) int and ``cache_pos`` (int, the cache
    position of the first token).  Runs the ``dense0`` layers, then the
    stacked ones, writing the tokens' KV into ``cache`` in place, and
    returns ``(logits (B, S, vocab) bf16, cache)``."""
    tokens = batch["tokens"]
    cache_pos = int(batch["cache_pos"])
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = (cache_pos + torch.arange(S, device=x.device,
                                          dtype=torch.int32))[None].expand(B, S)
    for part in ("dense0", "layers"):
        if part not in params:
            continue
        lp, kv = params[part], cache[part]
        for i in range(next(iter(kv.values())).shape[0]):
            x = _block(cfg, _layer(lp, i), x, positions=positions,
                       cache={k: v[i] for k, v in kv.items()},
                       cache_pos=cache_pos)
    x = L.norm(x, params["final_norm"], cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, cache


def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One forward over ``batch["tokens"]`` at ``batch["cache_pos"]``
    (a prompt or a single token) with the cache → ``(logits, cache)``."""
    with torch.no_grad():
        return forward(cfg, params, batch, cache)
