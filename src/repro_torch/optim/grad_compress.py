"""int8 gradient compression with error feedback — the reference's
``repro.optim.grad_compress``, over the port's parameter dicts.

Each gradient plus its carried residual is quantised to int8 with one
per-tensor max scale; the dequantised gradient is what an all-reduce
would see, and the quantisation residual stays in a bf16 error buffer
so the compression is unbiased over steps.  On a mesh a leaf's scale is
its max over every shard (one all-reduce for all leaves), as the
reference's ``jnp.max`` over a sharded array gives it, and the residual
keeps the leaf's placements.
"""

from __future__ import annotations

import torch

from ..models.sharding import is_dtensor, local
from ..tree import leaves_with_paths, map_tree


def init_error_feedback(params: dict) -> dict:
    """A zero bf16 residual beside each parameter (with its placements,
    on a mesh)."""
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.bfloat16,
                                               requires_grad=False), params)


def quantize(g: torch.Tensor, amax=None):
    """f32 ``g`` → ``(int8 codes, f32 scale)``: ``scale = (max|g| +
    1e-12) / 127``, codes ``round(g / scale)`` (half to even, as
    ``jnp.round``) clipped to ±127.  ``amax``: max|g| over the whole
    leaf when ``g`` is one shard of it (default: ``g``'s own)."""
    amax = g.abs().amax() if amax is None else amax
    scale = (amax + 1e-12) / 127.0
    return torch.round(g / scale).clamp(-127, 127).to(torch.int8), scale


def _g32(g, e) -> torch.Tensor:
    """A leaf's gradient plus its residual in f32 (a DTensor's shard)."""
    return local(g).float() + local(e).float()


def _global_amax(pairs: list, sharded: list) -> list:
    """Each leaf's max|g + e|: a sharded leaf's over every rank (one
    all-reduce on the default group, on its stream, joined through
    events: a CUDA graph captures it).  Each f32 sum is dropped once its
    max is read, so the pass holds one leaf's at a time."""
    amax = [_g32(g, e).abs().amax() for g, e in pairs]
    if any(sharded):
        import torch.distributed as dist

        both = torch.stack(amax)
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        amax = [both[i] if d else a for i, (a, d) in enumerate(zip(amax,
                                                                  sharded))]
    return amax


@torch.no_grad()
def compress_grads(grads: dict, error_buf: dict):
    """Add each residual to its gradient in f32, quantise, and return
    ``(dequantised grads in the grads' dtypes, new bf16 residuals)``.

    The residual is ``g32 − q·scale`` as the reference's compiled CPU
    graph computes it: XLA contracts it into one fused multiply-add, so
    the port forms the exact product and difference in f64 and rounds
    once to f32 (then to bf16); bit-equal to the reference on the CPU,
    and the same on the card."""
    paths = [k for k, _ in leaves_with_paths(grads)]
    gs, es = dict(leaves_with_paths(grads)), dict(leaves_with_paths(error_buf))
    pairs = [(gs[k], es[k]) for k in paths]
    amaxes = _global_amax(pairs, [is_dtensor(gs[k]) for k in paths])
    out = {k: _compress_leaf(g, e, amax)
           for k, (g, e), amax in zip(paths, pairs, amaxes)}

    def pick(i):
        def walk(tree, prefix):
            return {n: walk(v, f"{prefix}{n}/") if isinstance(v, dict)
                    else out[f"{prefix}{n}"][i] for n, v in tree.items()
                    if v is not None}
        return walk(grads, "")

    return pick(0), pick(1)


def _compress_leaf(g, e, amax) -> tuple:
    """One leaf's ``(dequantised gradient, new residual)``; its f32 and
    f64 temporaries die when it returns."""
    g32 = _g32(g, e)
    q, scale = quantize(g32, amax)
    deq = q.float() * scale
    resid = (g32.double() - q.double() * scale.double()).float()
    return (_like(g, deq.to(g.dtype)), _like(e, resid.to(torch.bfloat16)))


def _like(ref, t: torch.Tensor):
    """``t`` (a local shard) as a DTensor with ``ref``'s placements, or
    ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def compressed_bytes(params: dict) -> int:
    """Wire bytes of one all-reduce under int8 compression: a byte an
    element plus a 4-byte scale a tensor."""
    return sum(p.numel() + 4 for _, p in leaves_with_paths(params))
