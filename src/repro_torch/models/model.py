"""Dense GQA decoder: parameter layout, seeded init, conversion from the
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


def _check_dense(cfg: ArchConfig):
    if (cfg.family != "dense" or cfg.mla or cfg.n_experts or cfg.ssm
            or cfg.first_dense or not cfg.causal or cfg.norm != "rmsnorm"
            or not cfg.uses_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported (ROADMAP.md "
            "Queue 1 item 11 lists the other families)")


def schema(cfg: ArchConfig) -> Dict[str, object]:
    """Nested dict of ``(shape, init)`` leaves: ``"normal"`` (scaled by
    1/sqrt(fan_in)) or ``"zeros"`` — the reference's dense schema."""
    _check_dense(cfg)
    d, V, Lk = cfg.d_model, cfg.vocab, cfg.n_layers
    H, KV, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    attn = {
        "norm": {"scale": ((Lk, d), "zeros")},
        "wq": ((Lk, d, H * hd), "normal"),
        "wk": ((Lk, d, KV * hd), "normal"),
        "wv": ((Lk, d, KV * hd), "normal"),
        "wo": ((Lk, H * hd, d), "normal"),
    }
    if cfg.qkv_bias:
        attn["bq"] = ((Lk, H * hd), "zeros")
        attn["bk"] = ((Lk, KV * hd), "zeros")
        attn["bv"] = ((Lk, KV * hd), "zeros")
    mlp = {
        "norm": {"scale": ((Lk, d), "zeros")},
        "w1": ((Lk, d, f), "normal"),
        "w2": ((Lk, f, d), "normal"),
        "w3": ((Lk, d, f), "normal"),
    }
    s: Dict[str, object] = {
        "embed": ((V, d), "normal"),
        "layers": {"attn": attn, "mlp": mlp},
        "final_norm": {"scale": ((d,), "zeros")},
    }
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
        return (w * (1.0 / np.sqrt(fan_in))).to(DTYPE)

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


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: Device = None, dtype: Optional[torch.dtype] = None
               ) -> dict:
    """Decode-time KV cache ``{"layers": {"k", "v"}}`` of shape
    (layers, batch, max_seq, kv_heads, hd) in ``cfg.kv_dtype`` (bf16 or
    fp8-e4m3) on ``device``."""
    _check_dense(cfg)
    dev = devices.resolve(device)
    dtype = dtype or KV_DTYPES[cfg.kv_dtype]
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def forward(cfg: ArchConfig, params: dict, batch: dict,
            cache: dict) -> Tuple[torch.Tensor, dict]:
    """``batch``: ``tokens`` (B, S) int and ``cache_pos`` (int, the cache
    position of the first token).  Writes the tokens' K/V into ``cache``
    in place and returns ``(logits (B, S, vocab) bf16, cache)``."""
    tokens = batch["tokens"]
    cache_pos = int(batch["cache_pos"])
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = (cache_pos + torch.arange(S, device=x.device,
                                          dtype=torch.int32))[None].expand(B, S)
    lp = params["layers"]
    kv = cache["layers"]
    for i in range(cfg.n_layers):
        p = _layer(lp, i)
        x = x + L.gqa_block(x, p["attn"], cfg, positions=positions,
                            cache={"k": kv["k"][i], "v": kv["v"][i]},
                            cache_pos=cache_pos)
        x = x + L.mlp_block(x, p["mlp"], cfg)
    x = L.rmsnorm(x, params["final_norm"]["scale"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, cache


def decode_step(cfg: ArchConfig, params: dict, batch: dict, cache: dict):
    """One forward over ``batch["tokens"]`` at ``batch["cache_pos"]``
    (a prompt or a single token) with the cache → ``(logits, cache)``."""
    with torch.no_grad():
        return forward(cfg, params, batch, cache)
