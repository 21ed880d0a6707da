"""Nested dicts of tensors, the port's pytrees: their leaves in the
reference's order, named as the reference names them."""

from __future__ import annotations


def leaves_with_paths(tree: dict, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in sorted key order — the order
    ``jax.tree.leaves`` gives a dict — with the keys ``"/"``-joined as
    the reference's checkpoint names them from ``tree_flatten_with_path``
    (``opt/mu/layers/attn/wq``).  A None is an empty subtree."""
    out = []
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out += leaves_with_paths(v, path)
        elif v is not None:
            out.append((path, v))
    return out


def map_tree(fn, tree: dict, *rest: dict) -> dict:
    """``fn(leaf, *same_leaf_of_each_rest)`` over ``tree``'s leaves, in
    its structure."""
    return {k: map_tree(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
