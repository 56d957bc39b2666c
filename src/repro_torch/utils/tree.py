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
