"""Model building blocks: RMSNorm / LayerNorm, RoPE, GQA attention
(causal or bidirectional, sliding-window, over a linear or a rolling
cache) and MLA attention, the SwiGLU / squared-ReLU / GELU MLPs, the
top-k MoE with shared experts, and the Mamba1 / Mamba2 mixers with their
depthwise causal conv, as functions on tensors.

Numerics follow the reference's bf16 graph op for op (f32 norm
statistics, f32 rotary angles, f32 attention scores and softmax, bf16
activations between blocks), so the two frameworks differ only where
bf16 rounds at other places inside a fused op.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import spans
from ..kernels.decode_attn import decode_attention
from .sharding import (
    all_to_all, axis_sizes, coordinate, current_rules, gather_rows, gathered,
    logical, sharded_batch_dims, split_rows, sum_over,
)

_MASKED = -1e30


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    """``1.0 + scale`` rounds in the scale's dtype (bf16), as the
    reference's weakly-typed scalar add does; the bias adds in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale).float() + bias.float()).to(x.dtype)


def norm(x, p, kind: str):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def rope(x, positions, theta: float = 1e4, *, freqs=None, gain: float = 1.0):
    """x: (B, S, H, hd); positions: (B, S) int.  ``freqs`` (hd / 2,) f32
    in place of ``theta``'s and ``gain`` on cos and sin where a scaled
    rotary embedding gives them (:func:`yarn`)."""
    hd = x.shape[-1]
    half = hd // 2
    if freqs is None:
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (B, S, half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    if gain != 1.0:
        cos, sin = cos * gain, sin * gain
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn(cfg, dim: int, device):
    """YaRN's rotary frequencies (dim / 2,) f32, its gain on cos and sin
    and its gain on the softmax scale, from ``cfg.rope_*`` as DeepSeek's
    ``modeling_deepseek.py`` computes them (``DeepseekV3YarnRotaryEmbedding``
    in f32, the attention's ``softmax_scale``): each frequency blends
    ``theta``'s and that over the factor along a linear ramp between the
    dimensions that turn ``beta_fast`` and ``beta_slow`` times over the
    original context.  A factor of 1 or less: ``(None, 1.0, 1.0)``, the
    plain rotary embedding."""
    f = cfg.rope_factor
    if f <= 1:
        return None, 1.0, 1.0
    base, orig = cfg.rope_theta, cfg.rope_original_max

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    lo = max(math.floor(corr(cfg.rope_beta_fast)), 0)
    hi = min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)
    hi = hi + 0.001 if lo == hi else hi
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (f * base ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    mask = 1.0 - ramp
    freqs = inter * (1 - mask) + extra * mask
    m_all = cfg.rope_mscale_all_dim
    gain = _yarn_mscale(f, cfg.rope_mscale) / _yarn_mscale(f, m_all)
    soft = _yarn_mscale(f, m_all) ** 2 if m_all else 1.0
    return freqs, gain, soft


def _prefill_span(name: str, S: int):
    """A span of an eager prefill (S > 1); a decode step, which the
    serving engine captures, opens none."""
    return spans.span(name) if S > 1 else spans.OFF


def _const(v: float, like):
    """A scalar rounded to ``like``'s dtype first, as the reference's
    weakly-typed scalars are (PyTorch keeps a Python scalar in f32).  A
    0-d host tensor, which an op on the card takes as a scalar: no copy
    to the card, no wait on it."""
    return torch.tensor(v, dtype=like.dtype)


def _scale(q) -> float:
    """The attention scale ``hd**-0.5``, rounded to q's dtype as the
    reference's weakly-typed scalar is.  The reference's compiled graph
    then multiplies q by it in f32 and feeds the product to the f32
    score dot unrounded (XLA drops the bf16 round trip), so the port
    scales in f32 too."""
    return float(_const(q.shape[-1] ** -0.5, q))


def attention(q, k, v, *, q_positions, causal: bool = True, window: int = 0,
              k_positions=None, kv_valid_len=None, q_chunk: int = 0,
              scale=None):
    """GQA attention (plain PyTorch; the prefill path and every
    rolling-window or bidirectional one).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.  Key ``t``
    sits at ``k_positions[:, t]`` (default: position ``t``).  ``causal``
    masks keys after the query, ``window`` > 0 keys at or more than
    ``window`` positions before it, ``kv_valid_len`` (an int or a 0-d
    tensor on the device) slots at or past it;
    ``q_chunk`` > 0 processes query chunks to bound score memory (the
    last one shorter where it does not divide Sq; the reference then
    takes all the queries at once);
    ``scale`` replaces the softmax scale ``hd**-0.5`` (:func:`_scale`).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = _scale(q) if scale is None else scale
    qg = (q.float() * scale).reshape(B, Sq, KV, H // KV, hd)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=q.device)[None]
    k_pos = k_positions[:, None, None, None, :]
    kf, vf = k.float(), v.float()

    def block(qb, qpos):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kf)
        qp = qpos[:, None, None, :, None]
        m = torch.ones_like(k_pos, dtype=torch.bool)
        if causal:
            m = m & (k_pos <= qp)
        if window:
            m = m & (k_pos > qp - window)
        if kv_valid_len is not None:
            m = m & (k_pos < kv_valid_len)
        s = torch.where(m, s, torch.full_like(s, _MASKED))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
        return o.to(q.dtype)

    qpos = q_positions.expand(B, Sq)
    if q_chunk and Sq > q_chunk:
        out = torch.cat([block(qg[:, i : i + q_chunk], qpos[:, i : i + q_chunk])
                         for i in range(0, Sq, q_chunk)], dim=1)
    else:
        out = block(qg, qpos)
    return out.reshape(B, Sq, H, v.shape[-1])


def _bits(t):
    """``t`` viewed as the integer type of its width, so an indexed copy
    moves its bytes as they are, whatever the float type (fp8 included)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _write_slots(buf, slots, new):
    """``buf[:, slots] = new`` in place, ``new`` cast to ``buf``'s dtype:
    ``buf`` (B, W, ...), ``slots`` (S,) int64 on its device, distinct.
    An ``index_copy_`` of the bytes: no host read of ``slots``."""
    _bits(buf).index_copy_(1, slots, _bits(new.to(buf.dtype)))


def _write_at(buf, cache_pos, new):
    """Write ``new`` (B, S, ...) into the cache ``buf`` (B, Smax, ...) at
    ``cache_pos`` … ``cache_pos + S - 1``, in place: a slice for a host
    position, :func:`_write_slots` at ``cache_pos + arange(S)`` for a
    device one (the reference's ``dynamic_update_slice`` at a traced
    position)."""
    S = new.shape[1]
    if isinstance(cache_pos, int):
        buf[:, cache_pos : cache_pos + S] = new.to(buf.dtype)
        return
    _write_slots(buf, cache_pos.long() + torch.arange(S, device=buf.device),
                new)


def gqa_block(x, p, cfg, *, positions, cache=None, cache_pos=0,
              window: int = 0):
    """norm → qkv (+bias; +rope for a causal model) → attention → out proj.

    ``cache`` None: the tokens attend to each other (``cfg.causal`` or
    bidirectional, within ``window``).  A linear cache holds this layer's
    ``k``/``v`` (B, Smax, KV, hd), updated in place at ``cache_pos``; one
    token (S == 1) attends through the decode-attention kernel, a prompt
    through plain PyTorch.  A rolling cache also holds ``kpos`` (B, W):
    see :func:`_rolling_attention`.  ``cache_pos``: an int, or a 0-d int32
    tensor on the device that nothing here reads on the host.
    """
    B, S, _ = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = norm(x, p["norm"], cfg.norm)
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.reshape(B, S, H, hd), k.reshape(B, S, KVh, hd)
    v = v.reshape(B, S, KVh, hd)
    if cfg.causal:                  # RoPE only for decoder families
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    chunk = 256 if S > 1024 else 0
    if cache is None:
        q = logical(q, "batch", "seq", "heads", None)
        k = logical(k, "batch", "seq", "kv_heads", None)
        out = attention(q, k, v, q_positions=positions, causal=cfg.causal,
                        window=window, q_chunk=chunk)
    elif "kpos" in cache:
        out = _rolling_attention(q, k, v, cache, positions, window, chunk)
    else:
        kc, vc = cache["k"], cache["v"]
        _write_at(kc, cache_pos, k)
        _write_at(vc, cache_pos, v)
        kc = logical(kc, "batch", "kv_seq", "kv_heads", None)
        vc = logical(vc, "batch", "kv_seq", "kv_heads", None)
        if S == 1:
            o = decode_attention(q[:, 0].contiguous(), kc, vc,
                                 valid_len=cache_pos + 1, scale=_scale(q))
            out = o.to(q.dtype)
        else:
            out = attention(q, kc.to(k.dtype), vc.to(v.dtype),
                            q_positions=positions, window=window,
                            kv_valid_len=cache_pos + S, q_chunk=chunk)
    return out.reshape(B, S, H * hd) @ p["wo"]


def _rolling_attention(q, k, v, cache, positions, window: int, chunk: int):
    """Attention over a rolling-window cache, then the cache write.

    The cache's ``k``/``v`` (B, W, KV, hd) hold W slots; ``kpos`` (B, W)
    int32 the absolute position each slot holds (a stale slot holds one
    the window always excludes).  The new tokens at ``positions`` attend
    causally within ``window`` over the cache's slots and their own
    fresh K/V together, so a prompt's early tokens still see what its
    later ones overwrite; then position ``t`` takes slot ``t % W`` and
    every written slot records its position (a prompt longer than W
    leaves its last W tokens).  Always plain PyTorch: the decode kernel
    has no per-slot position mask.
    """
    kc, vc, kpos = cache["k"], cache["v"], cache["kpos"]
    W, S = kc.shape[1], k.shape[1]
    keys = torch.cat([kc.to(k.dtype), k], dim=1)
    vals = torch.cat([vc.to(v.dtype), v], dim=1)
    kp = torch.cat([kpos, positions.to(kpos.dtype)], dim=1)
    out = attention(q, keys, vals, q_positions=positions, window=window,
                    k_positions=kp, q_chunk=chunk)
    keep = min(S, W)
    slots = positions[0, S - keep:].long() % W
    _write_slots(kc, slots, k[:, S - keep:])
    _write_slots(vc, slots, v[:, S - keep:])
    _write_slots(kpos, slots, positions[:, S - keep:])
    return out


# MLA layer passes since import by path: [absorbed, re-expanded].  A
# decode step's caller reads them around the step, as ``build.LAUNCHES``.
MLA_PATHS = [0, 0]


def _expanded_attention(q_nope, q_rope, c_all, k_rope_all, p, scale, *,
                        positions, k_positions, valid):
    """MLA attention with K and V re-expanded from the latents ``c_all``
    (B, Sk, r) at every head: K (hd + rd wide) is ``c_all @ w_uk`` beside
    the shared rope key ``k_rope_all`` (B, Sk, 1, rd), V ``c_all @ w_uv``;
    :func:`attention` over them.  q_nope (B, S, H, hd), q_rope (B, S, H,
    rd) → (B, S, H, vh)."""
    B, Sk, S, H = *c_all.shape[:2], *q_nope.shape[1:3]
    k_nope = (c_all @ p["w_uk"]).reshape(B, Sk, H, -1)
    v = (c_all @ p["w_uv"]).reshape(B, Sk, H, -1)
    rd = k_rope_all.shape[-1]
    k = torch.cat([k_nope, k_rope_all.expand(B, Sk, H, rd)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    return attention(qfull, k, v, q_positions=positions,
                     k_positions=k_positions, kv_valid_len=valid,
                     q_chunk=256 if S > 1024 else 0, scale=scale)


def _bmm_f32(a, b):
    """``torch.bmm`` of bf16 operands, summed and returned in f32: the
    card's cuBLAS takes the f32 output itself; the CPU, which has no such
    kernel, takes the same products from operands widened to f32
    (exactly)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _absorbed_attention(q_nope, q_rope, c_kv, k_rope, p, scale, valid):
    """One query position's MLA attention over the latent cache with the
    up-projections absorbed (DeepSeek-V2 §2.1.2): ``w_uk`` maps the query
    into the latent, q_lat (B, H, r); every head scores q_lat · c_kv +
    q_rope · k_rope against the one shared latent (MQA with a key r + rd
    wide and a value r wide); ``w_uv`` maps each head's attended latent
    (B, H, r) to its output.  The same mathematics as
    :func:`_expanded_attention`, in another order.

    q_nope (B, H, hd), q_rope (B, H, rd); the cache's ``c_kv`` (B, Smax,
    r) and ``k_rope`` (B, Smax, 1, rd), bf16 or float8, whose slots at or
    past ``valid`` (an int or a 0-d tensor on the device) are masked.
    q_lat stays f32 (:func:`_bmm_f32`), the scale multiplies it in f32,
    and scores, softmax and P · c_kv are f32.  The attended latent goes
    into ``w_uv``'s bf16 product as two bf16 parts, its rounding and the
    rest, in one batch, so that only the heads' output rounds to bf16:
    rounded once, the latent would carry an error the expanded path's V
    spreads over every attended position.  ``w_uk`` and ``w_uv`` are
    read through strided batch views, (H, hd, r) and (H, r, vh): never
    copied.  → (B, H, vh) in q's dtype.
    """
    B, H, hd = q_nope.shape
    r, Sk = c_kv.shape[-1], c_kv.shape[1]
    uk = p["w_uk"].view(r, H, hd).permute(1, 2, 0)
    uv = p["w_uv"].view(r, H, -1).transpose(0, 1)
    q_lat = _bmm_f32(q_nope.transpose(0, 1), uk).transpose(0, 1)
    c = c_kv.float()
    s = (torch.bmm(q_lat * scale, c.transpose(1, 2))
         + torch.bmm(q_rope.float() * scale,
                     k_rope[:, :, 0].float().transpose(1, 2)))
    s = torch.where(torch.arange(Sk, device=s.device) < valid, s, _MASKED)
    o_lat = torch.bmm(torch.softmax(s, dim=-1), c)
    hi = o_lat.to(q_nope.dtype)
    parts = torch.cat([hi, (o_lat - hi.float()).to(hi.dtype)])
    o = _bmm_f32(parts.transpose(0, 1), uv)                  # (H, 2B, vh)
    return (o[:, :B] + o[:, B:]).transpose(0, 1).to(q_nope.dtype)


def mla_block(x, p, cfg, *, positions, cache=None, cache_pos=0):
    """DeepSeek-V2 multi-head latent attention over a latent cache.

    The cache holds this layer's ``c_kv`` (B, Smax, kv_lora_rank) latent
    and shared rope key ``k_rope`` (B, Smax, 1, qk_rope_dim), written in
    place at ``cache_pos``.  The query's length picks the attention: one
    position against a cache (a decode step) attends over the cached
    latent with the up-projections absorbed (:func:`_absorbed_attention`:
    it reads the latent once, and K and V are never made); a prompt, or
    tokens without a cache, re-expand K and V from the latents and attend
    in plain PyTorch, as the reference does (:func:`_expanded_attention`:
    the expansion is shared by the S queries, where absorbing ``w_uv``
    would cost each of them an (r, vh) product a head).  ``cache`` None:
    the tokens' own latents, causally.  :data:`MLA_PATHS` counts the
    passes by path.  With ``cfg.q_lora_rank`` the query goes through its
    low-rank projection ``wq_a``, an RMSNorm and ``wq_b`` (DeepSeek-V3);
    with ``cfg.rope_factor`` > 1 the rotary embedding and the softmax
    scale are YaRN's (:func:`yarn`).
    """
    B, S, _ = x.shape
    H, hd, r = cfg.n_heads, cfg.hd, cfg.kv_lora_rank
    rd, vh = cfg.qk_rope_dim, cfg.v_head_dim or cfg.hd
    h = norm(x, p["norm"], cfg.norm)
    if cfg.q_lora_rank:
        with _prefill_span("mla.q_lora", S):
            q = rmsnorm(h @ p["wq_a"], p["q_norm"]["scale"]) @ p["wq_b"]
    else:
        q = h @ p["wq"]
    q = q.reshape(B, S, H, hd + rd)
    freqs, gain, soft = yarn(cfg, rd, x.device)
    q_rope = rope(q[..., hd:], positions, cfg.rope_theta, freqs=freqs,
                  gain=gain)
    ckv_full = h @ p["w_dkv"]                              # (B, S, r + rd)
    c_kv = rmsnorm(ckv_full[..., :r], p["kv_norm"]["scale"])
    k_rope = rope(ckv_full[..., None, r:], positions, cfg.rope_theta,
                  freqs=freqs, gain=gain)
    scale = _scale(q) if soft == 1.0 else (hd + rd) ** -0.5 * soft
    if cache is None:
        MLA_PATHS[1] += 1
        out = _expanded_attention(q[..., :hd], q_rope, c_kv, k_rope, p, scale,
                                  positions=positions, k_positions=positions,
                                  valid=None)
    else:
        cc, kc = cache["c_kv"], cache["k_rope"]
        _write_at(cc, cache_pos, c_kv)
        _write_at(kc, cache_pos, k_rope)
        if S == 1:
            MLA_PATHS[0] += 1
            out = _absorbed_attention(q[:, 0, :, :hd], q_rope[:, 0], cc, kc,
                                      p, scale, cache_pos + 1)
        else:
            MLA_PATHS[1] += 1
            out = _expanded_attention(
                q[..., :hd], q_rope, cc.to(h.dtype), kc.to(h.dtype), p,
                scale, positions=positions, k_positions=None,
                valid=cache_pos + S)
    return out.reshape(B, S, H * vh) @ p["wo"]


def silu(a):
    """``x * sigmoid(x)`` rounded to the input dtype after every op, as
    the reference's bf16 graph computes it (``F.silu`` rounds once)."""
    return a * (1 / (1 + torch.exp(-a)))


def gelu(a):
    """``jax.nn.gelu``'s default tanh form, rounded after every op as the
    reference computes it in bf16."""
    cube = a * a * a
    inner = _const(np.sqrt(2 / np.pi), a) * (a + _const(0.044715, a) * cube)
    return a * (0.5 * (1 + torch.tanh(inner)))


def mlp_apply(h, p, kind: str):
    if kind == "swiglu":
        z = silu(h @ p["w1"]) * (h @ p["w3"])
    elif kind == "squared_relu":
        z = F.relu(h @ p["w1"]).square()
    else:
        z = gelu(h @ p["w1"])
    z = logical(z, "batch", "seq", "mlp")
    return z @ p["w2"]


def mlp_block(x, p, cfg):
    """Pre-norm MLP (``cfg.mlp``: swiglu | squared_relu | gelu)."""
    return mlp_apply(norm(x, p["norm"], cfg.norm), p, cfg.mlp)


def _expert_ffn(buf, p, cfg):
    """Every expert on its rows: ``buf`` (E, n, d) → (E, n, d).  Like the
    reference's expert path, any MLP other than swiglu takes GELU."""
    if cfg.mlp == "swiglu":
        z = silu(buf @ p["w1"]) * (buf @ p["w3"])
    else:
        z = gelu(buf @ p["w1"])
    z = logical(z, "experts", "capacity", "moe_mlp")
    return z @ p["w2"]


def router_probs(flat, router):
    """The f32 softmax of the bf16 router logits ``flat @ router``."""
    return torch.softmax((flat @ router).float(), dim=-1)


def route(flat, router, k: int):
    """Top-k routing: the k largest :func:`router_probs` (ties to the
    lower expert index, as ``jax.lax.top_k`` takes them, through a stable
    descending sort) and their gates renormalised to sum to 1.  Returns
    ``(gates (T, k) f32, experts (T, k) int64)``."""
    probs = router_probs(flat, router)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    return gates / gates.sum(-1, keepdim=True), experts


def route_grouped(flat, router, bias, cfg):
    """DeepSeek-V3's ``noaux_tc`` routing, in f32 as the published
    ``MoEGate`` computes it: the sigmoid of the f32 router logits; the
    scores plus the correction ``bias`` choose, the unbiased scores
    weigh.  Each of the ``cfg.n_group`` groups of experts scores the sum
    of its top 2 biased scores, the top ``cfg.topk_group`` groups are
    kept, and the ``cfg.top_k`` experts of the kept groups with the
    largest biased scores are chosen (ties to the lower index, through
    stable descending sorts, as :func:`route`).  The gates are their
    unbiased scores over their sum, times ``cfg.routed_scale``.  Returns
    ``(gates (T, k) f32, experts (T, k) int64)``, experts numbered over
    the whole router."""
    T = flat.shape[0]
    E, G = router.shape[-1], cfg.n_group
    scores = torch.sigmoid(flat.float() @ router.float())
    biased = scores + bias.float()
    groups = biased.view(T, G, E // G).topk(2, dim=-1).values.sum(-1)
    top = torch.sort(groups, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.topk_group]
    kept = torch.zeros(T, G, dtype=torch.bool, device=flat.device)
    kept.scatter_(1, top, True)
    masked = biased.masked_fill(~kept.repeat_interleave(E // G, dim=1),
                                float("-inf"))
    experts = torch.sort(masked, dim=-1, descending=True,
                         stable=True).indices[:, :cfg.top_k]
    gates = scores.gather(1, experts)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * cfg.routed_scale, experts


def _route_tokens(flat, p, cfg):
    """:func:`route_grouped` for a sigmoid router, else the module's
    :func:`route` (looked up at the call, so a caller may pin it)."""
    if cfg.scoring == "sigmoid":
        return route_grouped(flat, p["router"], p["router_bias"], cfg)
    return route(flat, p["router"], cfg.top_k)


def balance_loss(probs, experts):
    """The Switch-style load-balance loss ``E * sum(frac_tokens *
    frac_probs)``: ``frac_tokens`` the share of tokens whose **first**
    choice is each expert, ``frac_probs`` the mean of the f32 router
    probabilities (the softmax of the bf16 logits, :func:`router_probs`)
    over the tokens.  f32 scalar; its gradient reaches the router through
    ``frac_probs`` only."""
    E = probs.shape[-1]
    frac_tokens = F.one_hot(experts[:, 0], E).float().mean(0)
    return E * (frac_tokens * probs.mean(0)).sum()


def capacity_slots(experts, n_experts: int, cap: int):
    """Each (token, choice)'s slot in its expert's capacity buffer, by a
    cumulative count over the (T·k, E) one-hot in row-major order, and
    whether the slot is below ``cap`` (``keep``; the rest are dropped)."""
    T, k = experts.shape
    onehot = F.one_hot(experts.reshape(-1), n_experts)
    pos = (onehot.cumsum(0) - 1).gather(1, experts.reshape(-1, 1))
    pos = pos.reshape(T, k)
    return pos, pos < cap


_PAIR_COUNTERS: list = []


@contextlib.contextmanager
def count_pairs(counter: torch.Tensor):
    """Every prefill's MoE layers inside the block add their (token,
    choice) pairs to ``counter`` (3,) int64 on the model's device:
    routed, routed to an expert this chip holds, and of those dropped by
    capacity.  Device adds, no sync; a decode step adds nothing."""
    _PAIR_COUNTERS.append(counter)
    try:
        yield
    finally:
        _PAIR_COUNTERS.pop()


def _count_pairs(keep, held=None):
    """A prompt's pairs into the counter in use, if any: ``keep`` (T, k)
    whether each pair found a slot, ``held`` whether this chip holds its
    expert (None: every expert is held)."""
    if not _PAIR_COUNTERS:
        return
    c = _PAIR_COUNTERS[-1]
    c[0] += keep.numel()
    if held is None:
        c[1] += keep.numel()
        c[2] += (~keep).sum()
    else:
        c[1] += held.sum()
        c[2] += (held & ~keep).sum()


def _held_span(p):
    """The ``moe.held`` span around a prompt's routed experts, carrying
    the held experts' weight bytes."""
    sp = spans.span("moe.held")
    if sp:
        sp.nbytes = sum(p[n].nbytes for n in ("w1", "w2", "w3") if n in p)
    return sp


def _held_experts(experts, cfg):
    """Each (token, choice)'s index among this chip's experts (0 where
    another chip holds its expert) and whether this chip holds it."""
    local = experts - cfg.expert_offset
    held = (local >= 0) & (local < cfg.n_experts)
    return torch.where(held, local, torch.zeros_like(local)), held


def _moe_dense_decode(flat, p, cfg, gates, experts):
    """Few tokens (S == 1): every expert on every token, combined by an
    f32 scatter-add of the gates — exact, no capacity drops.  With an
    expert share, the held experts, the others' gates zero."""
    if cfg.holds_share:
        experts, held = _held_experts(experts, cfg)
        gates = torch.where(held, gates, torch.zeros_like(gates))
    T = flat.shape[0]
    y_all = _expert_ffn(flat.expand(cfg.n_experts, T, -1), p, cfg)  # (E,T,d)
    weight = torch.zeros(T, cfg.n_experts, dtype=torch.float32,
                         device=flat.device)
    weight.scatter_add_(1, experts, gates)
    return torch.einsum("etd,te->td", y_all, weight.to(flat.dtype))


def _slots(pos, keep, cap: int):
    """Each (token, choice)'s slot, a dropped pair's the spill slot
    ``cap``: shapes that do not depend on the routing, so the buffers
    below trace on the ``meta`` device."""
    return torch.where(keep, pos, torch.full_like(pos, cap))


def _dispatch(flat, experts, pos, keep, n_experts: int, cap: int):
    """Each kept (token, choice)'s row of ``flat`` at its slot of the
    (E, cap, d) capacity buffer; dropped pairs land in a spill slot past
    ``cap`` that the buffer leaves out (copied out whole, so the expert
    matmuls see the layout, and sum in the order, they always had)."""
    k = experts.shape[1]
    buf = flat.new_zeros(n_experts, cap + 1, flat.shape[1])
    buf.index_put_((experts.reshape(-1), _slots(pos, keep, cap).reshape(-1)),
                   flat.repeat_interleave(k, dim=0))
    return buf[:, :cap].contiguous()


def _combine(y_buf, experts, pos, keep, gates):
    """Each token's kept expert outputs weighted by its gates and summed
    (a dropped pair reads the zero spill slot, so adds nothing)."""
    E, cap, d = y_buf.shape
    y_pad = torch.cat([y_buf, y_buf.new_zeros(E, 1, d)], dim=1)
    got = y_pad[experts, _slots(pos, keep, cap)]
    return (got * gates[..., None].to(y_buf.dtype)).sum(dim=1)


def _ep_axes(rules, B: int, S: int, n_experts: int):
    """The token axes of the expert-parallel path under ``rules`` (the
    batch dims + ``model``), or None where the reference takes the plain
    block: a single token, no ``model`` dim, experts that do not divide
    it, or local tokens that do not split over it."""
    if rules is None or S == 1 or not hasattr(rules.mesh, "get_group"):
        return None
    sizes = axis_sizes(rules.mesh)
    if "model" not in sizes or n_experts % sizes["model"]:
        return None
    if (B * S) % sizes["model"]:
        return None
    return tuple(a for a in ("pod", "data") if a in sizes) + ("model",)


def _moe_prefill_share(flat, p, cfg, gates, experts):
    """A prompt's routed experts where this chip holds a block of the
    router's: the uncut layer's capacity, ``int(max(1, capacity_factor *
    k * T / n_router))`` rows an expert, and the uncut layer's slot of
    each (token, choice) in its expert's buffer (the cumulative count
    over the pairs of that expert, row-major, which the other experts do
    not touch), so the held experts drop exactly what they drop in the
    uncut layer; pairs routed elsewhere add nothing here."""
    T, k = experts.shape
    E = cfg.n_experts
    cap = int(max(1, cfg.capacity_factor * k * T / cfg.n_router))
    local, held = _held_experts(experts, cfg)
    pos, keep = capacity_slots(torch.where(held, local, E), E + 1, cap)
    keep = keep & held
    _count_pairs(keep, held)
    with _held_span(p):
        buf = logical(_dispatch(flat, local, pos, keep, E, cap),
                      "experts", "capacity", "embed")
        return _combine(_expert_ffn(buf, p, cfg), local, pos, keep, gates)


def moe_block_ep(x, p, cfg, mesh, token_axes):
    """Expert-parallel MoE: the reference's ``moe_block_ep`` (shard_map +
    ``all_to_all``), on this rank's local tensors.

    ``x`` (B, S, d) holds this rank's batch rows, the same on every rank
    along ``model``; its B·S tokens split over ``model``, so the token
    axes (``token_axes``: the batch dims + ``model``) partition them and
    each rank routes its T_l tokens into a local capacity buffer of
    ``cap_l = int(max(1, capacity_factor * k * T_l / E))`` rows an expert
    — local capacity, so overflowing tokens drop as in the reference's
    expert-parallel path, not its plain block.  Experts are sharded over
    ``model`` (their weights gathered over the other dims only); one
    ``all_to_all`` moves each rank's (E, cap_l, d) buffer to the experts'
    owners as (E/M, M·cap_l, d), the expert FFN runs there, a second
    brings the results back, and the tokens' outputs are gathered over
    ``model`` again.  ``aux`` is ``E * sum(mean(frac_tokens) *
    mean(frac_probs))``, both means over every token axis.  Returns
    ``(out (B, S, d), aux)``."""
    if cfg.holds_share or cfg.scoring != "softmax":
        raise ValueError(
            f"{cfg.name}: the expert-parallel mesh path routes a softmax "
            "router over the experts the mesh holds; an expert share "
            f"({cfg.n_experts} of {cfg.n_router}) or a {cfg.scoring} router "
            "runs on one chip")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    M = axis_sizes(mesh)["model"]
    batch = token_axes[:-1]
    dense = gathered({n: p[n] for n in ("norm", "shared") if n in p},
                     differ=batch)
    router = gathered(p["router"], differ=token_axes)
    ffn = gathered({n: p[n] for n in ("w1", "w2", "w3") if n in p},
                   differ=batch, keep=("model",))
    h = norm(x, dense["norm"], cfg.norm)
    flat = split_rows(h.reshape(B * S, d), mesh, ("model",))
    T_l = flat.shape[0]
    cap = int(max(1, cfg.capacity_factor * k * T_l / E))
    gates, experts = route(flat, router, k)
    pos, keep = capacity_slots(experts, E, cap)
    buf = _dispatch(flat, experts, pos, keep, E, cap)
    # (E, cap, d) → from each rank its block of my experts → (E/M, M·cap, d)
    buf = all_to_all(buf, mesh, "model")
    buf = buf.reshape(M, E // M, cap, d).transpose(0, 1).reshape(
        E // M, M * cap, d)
    y = _expert_ffn(buf, ffn, cfg)
    y = y.reshape(E // M, M, cap, d).transpose(0, 1).contiguous()
    y = all_to_all(y, mesh, "model").reshape(E, cap, d)
    out = gather_rows(_combine(y, experts, pos, keep, gates), mesh,
                      ("model",)).reshape(B, S, d)
    n = coordinate(mesh, token_axes)[1]
    frac_tokens = sum_over(F.one_hot(experts[:, 0], E).float().mean(0),
                           mesh, token_axes) / n
    frac_probs = sum_over(router_probs(flat, router).mean(0), mesh,
                          token_axes) / n
    aux = E * (frac_tokens * frac_probs).sum()
    if cfg.n_shared_experts:
        out = out + mlp_apply(h, dense["shared"], cfg.mlp)
    return out, aux


def moe_block(x, p, cfg):
    """Pre-norm token-choice top-k MoE plus the shared experts.

    A prompt (S > 1) packs each (token, choice) into its expert's
    capacity buffer of ``int(max(1, capacity_factor * k * T / E))`` rows,
    dropping the overflow in the reference's cumsum order, and combines
    the expert outputs weighted by the gates; a single token takes the
    dense path.  Returns ``(out (B, S, d), aux)``: ``aux`` the prompt's
    :func:`balance_loss` over the experts :func:`route` chose, read from
    the probabilities of the bf16 router logits (the source's dtype;
    ROADMAP.md Queue 3); None for a single token, where the reference's
    is a zero (a decode step launches nothing for it), and for a sigmoid
    router, whose ``noaux_tc`` balancing is its correction bias.  Routing
    goes through the module's ``route`` (a sigmoid router's through
    :func:`route_grouped`), so a caller may pin it.

    With an expert share (``cfg.holds_share``) the router spans all
    ``cfg.n_router`` experts and this chip computes the part of the
    result its own ``cfg.n_experts`` give (:func:`_moe_prefill_share`,
    and the decode's dense path over the held experts); the shared
    experts are counted on every chip.

    On a mesh (rules installed) a prompt takes :func:`moe_block_ep`
    where the reference does; otherwise the block gathers the batch's
    tokens over the batch dims and routes them all, as the reference's
    global dispatch does, keeping this rank's rows (``aux``'s gradient
    split over the batch ranks, so their sum is the global one).
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    rules = current_rules()
    token_axes = _ep_axes(rules, B, S, E)
    if token_axes is not None:
        return moe_block_ep(x, p, cfg, rules.mesh, token_axes)
    p = gathered(p)
    h = norm(x, p["norm"], cfg.norm)
    flat = h.reshape(B * S, d)
    batch = sharded_batch_dims(rules) if S > 1 else ()
    if batch:
        flat = gather_rows(flat, rules.mesh, batch, partial_grad=True)
    T = flat.shape[0]
    with _prefill_span("moe.route", S):
        gates, experts = _route_tokens(flat, p, cfg)
    aux = None
    if S == 1:
        out = _moe_dense_decode(flat, p, cfg, gates, experts)
    elif cfg.holds_share:
        out = _moe_prefill_share(flat, p, cfg, gates, experts)
    else:
        cap = int(max(1, cfg.capacity_factor * k * T / E))
        pos, keep = capacity_slots(experts, E, cap)
        _count_pairs(keep)
        with _held_span(p):
            buf = logical(_dispatch(flat, experts, pos, keep, E, cap),
                          "experts", "capacity", "embed")
            out = _combine(_expert_ffn(buf, p, cfg), experts, pos, keep,
                           gates)
        if cfg.scoring == "softmax":
            aux = balance_loss(router_probs(flat, p["router"]), experts)
    if batch:
        index, n = coordinate(rules.mesh, batch)
        out = out[index * B * S : (index + 1) * B * S]
        if aux is not None:
            aux = aux.detach() + (aux - aux.detach()) / n
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_apply(h, p["shared"], cfg.mlp)
    return out, aux


def softplus(a):
    """``jax.nn.softplus`` as the reference computes it, ``logaddexp(a,
    0)`` = max(a, 0) + log1p(exp(-|a|)), in a's dtype (f32 on the mixers'
    path).  ``F.softplus`` takes ``log1p(exp(a))`` below its threshold of
    20 and the identity above: in f32 the two forms agree to an ulp or
    two, and the port keeps the reference's."""
    return a.clamp_min(0) + torch.log1p(torch.exp(-a.abs()))


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv: x (B, S, C), kernel w (C, K), bias b (C,).
    ``state`` (B, K-1, C) holds the K-1 inputs before x (zeros if None).

    ``y[t] = sum_j xin[t + j] * w[:, j]`` over the inputs with the state
    in front, as K shifted products accumulated in f32 and rounded to x's
    dtype once (as XLA's grouped conv rounds), then the bias added in
    x's dtype.  Returns ``(y, the last K-1 inputs)``: the next state."""
    B, S, C = x.shape
    K = w.shape[-1]
    head = (x.new_zeros(B, K - 1, C) if state is None
            else state.to(x.dtype))
    xin = torch.cat([head, x], dim=1)
    xf, wf = xin.float(), w.float()
    acc = xf[:, :S] * wf[:, 0]
    for j in range(1, K):
        acc = torch.addcmul(acc, xf[:, j : j + S], wf[:, j])
    return acc.to(x.dtype) + b, xin[:, S:]


_SCAN_STEPS: list = []


@contextlib.contextmanager
def scan_steps(n: int):
    """Every selective scan runs only its first ``n`` steps and repeats
    the last step's output, detached, for the rest: the dry run's
    trip-count correction (``launch.dryrun``), the counterpart of the
    reference's ``scan_unroll``.  Every step past the first costs the
    same ops, so traces at a few step counts extrapolate to the prompt's
    length; the values are wrong, the shapes are the run's."""
    _SCAN_STEPS.append(n)
    try:
        yield
    finally:
        _SCAN_STEPS.pop()


def _scan(dA, dBx, C, h, heads: bool):
    """The selective scan, one step a token as the reference's
    ``lax.scan``: ``h = dA_t * h + dBx_t`` then ``y_t = h . C_t`` over the
    state's last axis, in f32.  Mamba1: h (B, di, N), dA / dBx (B, S, di,
    N); Mamba2 (``heads``): h (B, Hm, P, N), dA (B, S, Hm), dBx (B, S,
    Hm, P, N).  C (B, S, N) f32.  Returns ``(ys (B, S, ...), h)``."""
    B, S = dBx.shape[:2]
    steps = min(S, _SCAN_STEPS[-1]) if _SCAN_STEPS else S
    ys = []
    for t in range(steps):
        a = dA[:, t, :, None, None] if heads else dA[:, t]
        h = torch.addcmul(dBx[:, t], a, h)
        y = torch.bmm(h.reshape(B, -1, h.shape[-1]), C[:, t, :, None])
        ys.append(y.reshape(h.shape[:-1]))
    if steps < S:
        ys += [ys[-1].detach()] * (S - steps)
    return torch.stack(ys, 1), h


def _write_state(state, conv, h):
    """A decode step's new conv inputs and f32 scan state, in place."""
    state["conv"].copy_(conv.to(state["conv"].dtype))
    state["ssm"].copy_(h)


def mamba1_mix(x, p, cfg, state=None):
    """Mamba1 mixer (falcon-mamba): in_proj → conv → SiLU → x_proj →
    softplus dt → the f32 selective scan over (d_inner, N) → D skip →
    SiLU(z) gate → out_proj.  x (B, S, d) bf16 → (B, S, d).

    ``state``: this layer's ``conv`` (B, K-1, d_inner) and f32 ``ssm``
    (B, d_inner, N), read as the state before x and overwritten with the
    state after it; None starts from zeros and keeps nothing.  dtypes
    follow the reference op for op: bf16 projections, dt promoted to f32
    by the f32 ``dt_bias``, dA / dBx and the scan in f32, y back to bf16
    before the skip and the gate."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    r = max(d // 16, 1)
    xz = x @ p["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    xs = logical(xs, "batch", "seq", "d_inner")
    xs, conv = causal_conv1d(xs, p["conv_w"], p["conv_b"],
                             None if state is None else state["conv"])
    xs = silu(xs)
    xdbc = xs @ p["x_proj"]                       # (B, S, r + 2N)
    dt = softplus(xdbc[..., :r] @ p["dt_proj"] + p["dt_bias"])   # f32
    Bm, Cm = xdbc[..., r : r + N], xdbc[..., r + N :]
    A = -torch.exp(p["A_log"].float())            # (di, N)
    dA = torch.exp(dt[..., None] * A)             # (B, S, di, N)
    dBx = (dt * xs)[..., None] * Bm[:, :, None, :].float()
    h0 = (x.new_zeros(B, di, N, dtype=torch.float32) if state is None
          else state["ssm"].float())
    ys, h = _scan(dA, dBx, Cm.float(), h0, heads=False)
    y = ys.to(x.dtype) + xs * p["D"]
    y = y * silu(z)
    if state is not None:
        _write_state(state, conv, h)
    return y @ p["out_proj"]


def mamba2_mix(x, p, cfg, state=None):
    """Mamba2 mixer (zamba2's backbone; the SSD recurrence in scan form,
    as the reference runs it): one in_proj split into z / x / B / C /
    dt, a conv over x‖B‖C → SiLU, softplus dt per head, the f32 scan over
    (heads, P, N) → D skip → a gated rmsnorm → out_proj.  x (B, S, d)
    bf16 → (B, S, d).  ``state``: ``conv`` (B, K-1, d_inner + 2N) and
    f32 ``ssm`` (B, heads, P, N), as for :func:`mamba1_mix`."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    Hm = cfg.ssm_heads or max(di // 64, 1)
    P = di // Hm
    proj = x @ p["in_proj"]                       # (B, S, 2di + 2N + Hm)
    z = proj[..., :di]
    dt = softplus(proj[..., 2 * di + 2 * N :] + p["dt_bias"])    # f32
    conv_out, conv = causal_conv1d(proj[..., di : 2 * di + 2 * N],
                                   p["conv_w"], p["conv_b"],
                                   None if state is None else state["conv"])
    conv_out = silu(conv_out)
    xs = conv_out[..., :di].reshape(B, S, Hm, P)
    Bm, Cm = conv_out[..., di : di + N], conv_out[..., di + N :]
    A = -torch.exp(p["A_log"].float())            # (Hm,)
    dA = torch.exp(dt * A)                        # (B, S, Hm)
    dBx = (dt[..., None] * xs)[..., None] * Bm[:, :, None, None, :].float()
    h0 = (x.new_zeros(B, Hm, P, N, dtype=torch.float32) if state is None
          else state["ssm"].float())
    ys, h = _scan(dA, dBx, Cm.float(), h0, heads=True)
    y = ys.to(x.dtype) + xs * p["D"][:, None]
    y = rmsnorm(y.reshape(B, S, di) * silu(z), p["norm_gated"]["scale"])
    if state is not None:
        _write_state(state, conv, h)
    return y @ p["out_proj"]
