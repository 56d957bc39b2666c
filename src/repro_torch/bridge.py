"""Carry reference-package state into the port's form, bit for bit.

Input is the reference's tree with numpy leaves (callers map
``np.asarray`` over it on their side; this module imports no JAX and
nothing of the reference package). A quantized linear is any object with
``qweight`` / ``scales`` / ``zeros`` / ``input_scale`` / ``bias`` /
``group_size`` attributes.

  * `params_to_torch` — model params. ``segments/seg_i`` leaves are
    scan-stacked along a leading layer dim; they become a list of
    per-layer dicts (a MoE layer's stacked experts keep their expert
    dim: ``[L, E, ...]`` becomes ``[E, ...]`` a layer, a quantized one a
    `PackedLinear` with that leading dim).
  * `paged_cache_to_torch` — serving page pools (int8 codes + f32 scale
    strips, or float pools), unstacked the same way.
  * `tree_to_torch` — any subtree as it is (one linear, a config of
    tensors); `to_tensor` — any one array (page tables, positions).
  * `ef_to_torch` / `ef_to_arrays` — the int8 error-feedback residuals
    of `training.dp_compressed` (a leading data-shard dim a leaf: the
    reference's stacked leaf is ``[n, L, ...]``, the port's layer leaf
    ``[n, ...]``), both ways (`ef_to_torch` after `arrays_to_state`).
  * `state_to_arrays` / `arrays_to_state` — the other way and back: a
    port tree (a train state, params, quantized params) as the
    reference's ``{path: numpy array}`` with its layers stacked (the
    checkpoint format), and such a dict into the structure of a port
    template, unstacked as `params_to_torch` unstacks.

Like every entry point of the port, these put their tensors on ``cuda``
unless the caller passes ``device="cpu"``; asking for CUDA without a
card raises.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.packing import PackedLinear
from repro_torch.device import resolve_device
from repro_torch.utils.tree import layer_parts

_PACKED_FIELDS = ("qweight", "scales", "zeros", "input_scale", "bias")


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) → torch tensor with the same bits."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_packed(node: Any) -> bool:
    return all(hasattr(node, f) for f in _PACKED_FIELDS + ("group_size",))


def tree_to_torch(node: Any, device=None) -> Any:
    """Any reference subtree (dicts, quantized linears, numpy leaves) →
    the same structure of torch tensors / `PackedLinear`s."""
    device = resolve_device(device)
    if _is_packed(node):
        return PackedLinear(
            qweight=to_tensor(node.qweight, device),
            scales=to_tensor(node.scales, device),
            zeros=to_tensor(node.zeros, device),
            input_scale=to_tensor(node.input_scale, device),
            bias=None if node.bias is None else to_tensor(node.bias, device),
            group_size=int(node.group_size))
    if isinstance(node, dict):
        return {k: tree_to_torch(v, device) for k, v in node.items()}
    if node is None:
        return None
    return to_tensor(node, device)


def _unstack(node: Any, i: int) -> Any:
    """Layer ``i`` of a scan-stacked subtree (leading dim = layers)."""
    if isinstance(node, PackedLinear):
        return PackedLinear(
            **{f: None if getattr(node, f) is None else getattr(node, f)[i]
               for f in _PACKED_FIELDS}, group_size=node.group_size)
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i]


def _n_layers(node: Any) -> int:
    if isinstance(node, PackedLinear):
        return node.qweight.shape[0]
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    return node.shape[0]


def _unstack_segments(segments: dict) -> dict:
    return {name: [_unstack(seg, i) for i in range(_n_layers(seg))]
            for name, seg in segments.items()}


def params_to_torch(params: dict, device=None) -> dict:
    """Reference params (numpy leaves) → port params on ``device``."""
    out = tree_to_torch(params, device)
    out["segments"] = _unstack_segments(out["segments"])
    return out


def cache_to_torch(cache: dict, device=None) -> dict:
    """Reference one-shot decode cache (``init_cache``: ``{seg_i: {"kv" |
    "mla" | "ssm": {...}}}`` with ``[L, B, ...]`` leaves) → the port's
    ``{seg_i: [layer cache, ...]}``."""
    return _unstack_segments(tree_to_torch(cache, device))


def paged_cache_to_torch(cache: dict, device=None) -> dict:
    """Reference paged cache ``{seg_i: {"kv_pool": {k, v[, ks, vs]}}}`` with
    ``[L, N, P, Hkv, hd]`` leaves → ``{seg_i: [{"kv_pool": ...}, ...]}``."""
    return cache_to_torch(cache, device)


def ef_to_torch(arrays: dict, template: Any, device=None) -> Any:
    """EF residuals in the reference's layout (``{path: [n, L, ...]}`` for
    a stacked path, as `ef_to_arrays` writes them) → ``template``'s
    structure (the port's per-layer ``[n, ...]`` leaves) on ``device``."""
    stacked = {p for p, parts, _ in layer_parts(template) if parts is not None}
    return arrays_to_state({p: np.moveaxis(np.asarray(a), 1, 0)
                            if p in stacked else a
                            for p, a in arrays.items()}, template, device)


def ef_to_arrays(ef: Any) -> dict[str, np.ndarray]:
    """The port's EF residuals → ``{reference path: array}`` in the
    reference's layout (the shard dim first, then a path's layers)."""
    stacked = {p for p, parts, _ in layer_parts(ef) if parts is not None}
    return {p: np.moveaxis(a, 0, 1) if p in stacked else a
            for p, a in state_to_arrays(ef).items()}


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as host numpy, bf16 as its raw 16-bit words (int16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy()


def state_to_arrays(state: Any) -> dict[str, np.ndarray]:
    """Port tree → ``{reference path: host numpy array}`` in the reference's
    leaf order, each list of layers stacked along a leading dim on the host
    (no device copy). bf16 leaves become int16 words."""
    out = {}
    for path, parts, leaf in layer_parts(state):
        out[path] = (np.stack([host_numpy(t) for t in parts])
                     if parts is not None else host_numpy(leaf))
    return out


def _array_to(a: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """One array as a tensor of ``like``'s dtype on ``device``. A bf16
    leaf is read from 16-bit words (int16 as written here, or the
    reference's 2-byte bfloat16 records) bit for bit; any other is cast
    as the reference's restore casts (``astype``)."""
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind in "iuV":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=like.dtype)


def arrays_to_state(arrays: dict, template: Any, device=None) -> Any:
    """``{path: array}`` (as `state_to_arrays` or the reference's
    checkpoint writes it) → a tree of ``template``'s structure and dtypes
    (template leaves may be ``meta`` tensors) on ``device``. A list of
    layers takes row i of each stacked array, as `params_to_torch`
    unstacks the reference's segments."""
    device = resolve_device(device)
    leaves = {}
    for path, parts, leaf in layer_parts(template):
        a = arrays[path]
        if parts is None:
            leaves[path] = _array_to(a, leaf, device)
        else:
            leaves[path] = [_array_to(a[i], t, device)
                            for i, t in enumerate(parts)]

    def build(node, prefix, layer):
        if isinstance(node, list):
            return [build(n, prefix, i) for i, n in enumerate(node)]
        if isinstance(node, PackedLinear):
            return PackedLinear(**{
                f: None if getattr(node, f) is None
                else build(getattr(node, f), f"{prefix}/{f}", layer)
                for f in _PACKED_FIELDS}, group_size=node.group_size)
        if isinstance(node, dict):
            return {k: None if v is None
                    else build(v, f"{prefix}/{k}" if prefix else k, layer)
                    for k, v in node.items()}
        got = leaves[prefix]
        return got if layer is None else got[layer]
    return build(template, "", None)
