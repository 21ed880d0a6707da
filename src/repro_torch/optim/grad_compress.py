"""int8 gradient compression with error feedback — the reference's
``repro.optim.grad_compress``, over the port's parameter dicts.

Each gradient plus its carried residual is quantised to int8 with one
per-tensor max scale; the dequantised gradient is what an all-reduce
would see, and the quantisation residual stays in a bf16 error buffer
so the compression is unbiased over steps.
"""

from __future__ import annotations

import torch

from ..tree import leaves_with_paths, map_tree


def init_error_feedback(params: dict) -> dict:
    """A zero bf16 residual beside each parameter."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)


def quantize(g: torch.Tensor):
    """f32 ``g`` → ``(int8 codes, f32 scale)``: ``scale = (max|g| +
    1e-12) / 127``, codes ``round(g / scale)`` (half to even, as
    ``jnp.round``) clipped to ±127."""
    scale = (g.abs().amax() + 1e-12) / 127.0
    return torch.round(g / scale).clamp(-127, 127).to(torch.int8), scale


@torch.no_grad()
def compress_grads(grads: dict, error_buf: dict):
    """Add each residual to its gradient in f32, quantise, and return
    ``(dequantised grads in the grads' dtypes, new bf16 residuals)``.

    The residual is ``g32 − q·scale`` as the reference's compiled CPU
    graph computes it: XLA contracts it into one fused multiply-add, so
    the port forms the exact product and difference in f64 and rounds
    once to f32 (then to bf16); bit-equal to the reference on the CPU,
    and the same on the card."""
    def one(g, e):
        g32 = g.float() + e.float()
        q, scale = quantize(g32)
        deq = q.float() * scale
        resid = (g32.double() - q.double() * scale.double()).float()
        return deq.to(g.dtype), resid.to(torch.bfloat16)

    pairs = map_tree(one, grads, error_buf)
    first = map_tree(lambda t: t[0], pairs)
    return first, map_tree(lambda t: t[1], pairs)


def compressed_bytes(params: dict) -> int:
    """Wire bytes of one all-reduce under int8 compression: a byte an
    element plus a 4-byte scale a tensor."""
    return sum(p.numel() + 4 for _, p in leaves_with_paths(params))
