"""The served model's weights, drawn by the benchmark from the run's seed
on the device, in the layout the program takes (its parameter schema) and
in the type they are served in.

All leaves of one dtype are views of one buffer filled by one
``normal_`` call of a ``torch.Generator`` on the device; each leaf is then
scaled: a weight by ``1 / sqrt(fan_in)`` (its second-to-last axis), a
norm gain or a bias (the schema's zero-initialised leaves) by
``ZERO_INIT_STD``, so that they are exercised too.  The reference reads
the same tensors; nothing of the program's own initialisation is used.
"""

from __future__ import annotations

import math

import torch

ZERO_INIT_STD = 0.1
_SCALED = ("normal",)
_SMALL = ("zeros",)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(cfg, seed: int, device) -> dict:
    """Weights of the program config ``cfg`` from ``seed`` on ``device``:
    a nested dict in the program's parameter layout."""
    from repro_torch.models.model import leaf_dtype, schema

    specs = list(_leaves(schema(cfg)))
    by_dtype = {}
    for path, spec in specs:
        if spec.init not in _SCALED + _SMALL:
            raise ValueError(f"{'.'.join(path)}: init {spec.init!r} is not "
                             "drawn by the benchmark")
        by_dtype.setdefault(leaf_dtype(spec.init), []).append((path, spec))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out: dict = {}
    for dtype, group in by_dtype.items():
        total = sum(math.prod(s.shape) for _, s in group)
        buf = torch.empty(total, dtype=dtype, device=device)
        buf.normal_(generator=gen)
        off = 0
        for path, spec in group:
            n = math.prod(spec.shape)
            leaf = buf[off:off + n].view(spec.shape)
            off += n
            if spec.init in _SCALED:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                    else spec.shape[-1]
                leaf.mul_(1.0 / math.sqrt(fan_in))
            else:
                leaf.mul_(ZERO_INIT_STD)
            _set(out, path, leaf)
    return out
