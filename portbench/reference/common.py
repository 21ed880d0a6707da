"""Plain float32 pieces of the benchmark's reference decoders: norms,
rotary embedding, causal attention over a cache whose spilled pages were
read back at a precision view, the SwiGLU MLP, and the lower-precision
control's rounding.

Nothing here is tuned: one einsum per product, TF32 off (the caller's
:func:`fp32_matmul`), queries in blocks so that the scores fit beside
the served model's weights.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch

from . import views

Q_BLOCK = 256


@contextlib.contextmanager
def fp32_matmul():
    """Float32 products in float32: TF32 off while the reference runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class Numerics:
    """How the reference rounds: ``"f32"`` computes in float32; ``"fp8"``
    (the control) rounds every weight (per tensor) and every activation
    entering a product (per row) to float8 e4m3 with a scale, and keeps
    the KV cache in it."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def _q8(self, x: torch.Tensor, dims) -> torch.Tensor:
        if self.kind == "f32":
            return x
        amax = x.abs().amax(dim=dims, keepdim=True) if dims is not None \
            else x.abs().amax()
        scale = amax.clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight, as float32 (the control: through fp8, one scale)."""
        return self._q8(t.float(), None)

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a product (the control: through fp8,
        one scale a row)."""
        return self._q8(x, -1)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.a(x) @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the gain stored as ``1 + scale``."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
         freqs: Optional[torch.Tensor] = None, gain: float = 1.0
         ) -> torch.Tensor:
    """Rotary embedding on halves: x (B, S, H, d), positions (S,);
    ``freqs`` (d / 2,) in place of ``theta``'s and ``gain`` on cos and
    sin where a scaled rotary embedding gives them."""
    half = x.shape[-1] // 2
    if freqs is None:
        freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half)
    ang = (positions.double()[:, None] * freqs.to(x.device)).float()
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    if gain != 1.0:
        cos, sin = cos * gain, sin * gain
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(h: torch.Tensor, w1, w3, w2, num: Numerics) -> torch.Tensor:
    a = num.mm(h, w1)
    return num.mm(a * torch.sigmoid(a) * num.mm(h, w3), w2)


class CacheView:
    """Which cached positions of one layer's paged kind a query reads at a
    view: ``visible[j]`` the first step whose forward reads position j's
    view (a large number where it never does) and ``view[j]`` its name."""

    NEVER = 1 << 30

    def __init__(self, length: int, device):
        self.visible = torch.full((length,), self.NEVER, dtype=torch.int64,
                                  device=device)
        self.names: Dict[str, torch.Tensor] = {}

    def set(self, lo: int, hi: int, step: int, name: str):
        self.visible[lo:hi] = step
        mask = self.names.setdefault(
            name, torch.zeros_like(self.visible, dtype=torch.bool))
        mask[lo:hi] = True

    @property
    def empty(self) -> bool:
        return not self.names

    def apply(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """``x`` (positions along ``axis``) as read back: every position
        with a view takes it (whether a query sees it is :meth:`seen`'s
        business)."""
        out = x
        for name, mask in self.names.items():
            shape = [1] * x.dim()
            shape[axis] = -1
            out = torch.where(mask.view(shape), views.view_values(x, name),
                              out)
        return out

    def seen(self, q_steps: torch.Tensor) -> torch.Tensor:
        """(queries, keys) bool: the query at step ``q_steps[i]`` reads
        key j's view."""
        return q_steps[:, None] >= self.visible[None, :]


def query_steps(S: int, prompt_len: int, device) -> torch.Tensor:
    """The step each position's query runs in: 0 for the prompt, then one
    a decode step."""
    pos = torch.arange(S, device=device)
    return torch.clamp(pos - prompt_len + 1, min=0)


def attention(q, k, v, *, prompt_len: int, k_view=None, v_view=None,
              cv_k: Optional[CacheView] = None,
              cv_v: Optional[CacheView] = None,
              scale_gain: float = 1.0) -> torch.Tensor:
    """Causal attention, exact softmax.  q (B, S, H, dq); k (B, S, Hk, dq)
    and v (B, S, Hk, dv) with H % Hk == 0; ``k_view`` / ``v_view`` the
    same as read back, and ``cv_k`` / ``cv_v`` which query reads which;
    ``scale_gain`` multiplies the softmax scale ``dq ** -0.5``.
    Returns (B, S, H, dv)."""
    B, S, H, dq = q.shape
    Hk = k.shape[2]
    g = H // Hk
    scale = scale_gain / math.sqrt(dq)
    steps = query_steps(S, prompt_len, q.device)
    kpos = torch.arange(S, device=q.device)
    out = []
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        qb = q[:, lo:hi].reshape(B, hi - lo, Hk, g, dq) * scale
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, k)
        if cv_k is not None and not cv_k.empty:
            sv = torch.einsum("bqkgd,bskd->bkgqs", qb, k_view)
            s = torch.where(cv_k.seen(steps[lo:hi]), sv, s)
        causal = kpos[None, :] <= torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(~causal, float("-inf"))
        p = torch.softmax(s, dim=-1)
        if cv_v is not None and not cv_v.empty:
            seen = cv_v.seen(steps[lo:hi])
            o = (torch.einsum("bkgqs,bskd->bqkgd", p * ~seen, v)
                 + torch.einsum("bkgqs,bskd->bqkgd", p * seen, v_view))
        else:
            o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
        out.append(o.reshape(B, hi - lo, H, v.shape[-1]))
    return torch.cat(out, dim=1)


def cache_views(schedule, layers: int, kinds, length: int, page_tokens: int,
                device) -> Dict[tuple, CacheView]:
    """One :class:`CacheView` a (paged layer, kind) from a
    :func:`policy.schedule`."""
    out = {(layer, kind): CacheView(length, device)
           for layer in range(layers) for kind in kinds}
    for (layer, kind, start), spill in (schedule or {}).items():
        if start < length:
            out[(layer, kind)].set(start, min(length, start + page_tokens),
                                   spill.visible, spill.view)
    return out
