"""Path-aware helpers over the port's trees, addressed as the reference's.

The port keeps a model's layers as a list of per-layer dicts
(``params["segments"]["seg_0"][i]``) where the reference scan-stacks each
leaf along a leading layer dim. Checkpoints, gradients and the optimizer's
leaf order address a leaf by the reference's '/'-joined path, so these
helpers walk a port tree as the reference's ``jax.tree_util`` walks its
own: dict keys sorted, a `PackedLinear`'s fields in the order
``qweight / scales / zeros / input_scale / bias`` (a ``None`` field is no
leaf), and a list of layers restacked into one leaf per path, so that a
path reads ``params/segments/seg_0/attn/wq/w``.
"""
from __future__ import annotations

from typing import Any, Iterator

import torch

from repro_torch.core.packing import PackedLinear

PACKED_FIELDS = ("qweight", "scales", "zeros", "input_scale", "bias")


def path_str(path) -> str:
    """'/'-joined string for a sequence of keys."""
    return "/".join(str(k) for k in path)


def _children(node: Any) -> list[tuple[str, Any]]:
    if isinstance(node, PackedLinear):
        return [(f, getattr(node, f)) for f in PACKED_FIELDS
                if getattr(node, f) is not None]
    return [(k, node[k]) for k in sorted(node) if node[k] is not None]


def _child(node: Any, key: str) -> Any:
    return getattr(node, key) if isinstance(node, PackedLinear) else node[key]


def layer_parts(tree: Any) -> Iterator[tuple[str, list[torch.Tensor] | None,
                                             torch.Tensor | None]]:
    """``(path, parts, leaf)`` in the reference's leaf order: ``parts`` is
    the list of per-layer tensors of a restacked path (``leaf`` None), or
    ``leaf`` the tensor of a plain one (``parts`` None)."""
    def walk(node, prefix, layers):
        if isinstance(node, list):
            if not node:
                return
            # the layers share one structure: walk the first, carrying all
            yield from walk(node[0], prefix, node)
            return
        if isinstance(node, (dict, PackedLinear)):
            for key, child in _children(node):
                sub = None if layers is None else [_child(n, key)
                                                   for n in layers]
                yield from walk(child, f"{prefix}/{key}" if prefix else key,
                                sub)
            return
        if layers is not None:
            yield prefix, list(layers), None
        else:
            yield prefix, None, node
    yield from walk(tree, "", None)


def flatten_with_paths(tree: Any) -> list[tuple[str, torch.Tensor]]:
    """``[(path, leaf)]`` in the reference's order, each list of layers
    stacked into its leading dim (a copy)."""
    return [(p, torch.stack(parts) if parts is not None else leaf)
            for p, parts, leaf in layer_parts(tree)]


def leaf_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (meta tensors too)."""
    total = 0
    for _, parts, leaf in layer_parts(tree):
        for t in parts if parts is not None else [leaf]:
            total += t.numel() * t.element_size()
    return total


def leaf_count(tree: Any) -> int:
    """Total number of scalar elements across all leaves (meta tensors
    too)."""
    return sum(t.numel() for _, parts, leaf in layer_parts(tree)
               for t in (parts if parts is not None else [leaf]))


def map_tree(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over trees of one structure (dicts and
    lists of tensors), keeping it."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over a port tree (dicts, lists of layers,
    `PackedLinear` fields), keeping its structure; ``path`` is the
    reference's (a list of layers adds no index, as in `layer_parts`)."""
    def walk(node, prefix):
        if isinstance(node, list):
            return [walk(v, prefix) for v in node]
        if isinstance(node, dict):
            return {k: None if v is None
                    else walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, PackedLinear):
            raise TypeError("map_with_path walks float trees")
        return fn(prefix, node)
    return walk(tree, "")


def from_parts(tree: Any, parts: dict) -> Any:
    """``tree``'s structure with each leaf taken from ``parts[path]`` (a
    path's pieces in layer order, as `layer_parts` lists them)."""
    its = {p: iter(v) for p, v in parts.items()}
    return map_with_path(lambda p, _: next(its[p]), tree)
