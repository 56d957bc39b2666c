"""Meshes over torch devices, the sharding rules, and the explicit
collectives between shards: tensor-parallel serving over ``model``, and
training over ``(data, model)``.

The reference serves a tensor-parallel model from ONE controller (one
scheduler, one host pager, page tables replicated) and lets GSPMD place
the work: weights split by `param_pspec`, page pools striped over KV
heads by `paged_cache_pspec`, spill and handoff strips leaving the mesh
whole. The port keeps that architecture and spells the placement out:

  * a `Mesh` is a grid of torch devices with named axes; serving reads
    only the ``model`` axis of its first data replica (`model_devices`):
    the reference replicates over ``data`` / ``pod``, so the other
    replicas would compute the same bytes;
  * `shard_tree` turns an unsharded params or pool tree into one tree a
    shard, each on its shard's device: a leaf whose rule names
    ``"model"`` at dim d is cut into n equal pieces along d, each its own
    contiguous allocation (kernel K2 takes only contiguous, 16-byte
    aligned pools); any other leaf is replicated;
  * `place_cache` places a one-shot decode cache as `cache_pspec` says
    (a split leaf a list of pieces, one a shard; `shard_cache` its
    sequence-only case), `join_cache` joins it back;
  * every layer runs its shard-local function on each shard, and the
    reductions and gathers between shards are explicit, in shard order
    0 … n−1: `all_sum` (row-parallel partials) and `concat` (heads,
    vocab slices, column-parallel outputs). A replicated activation is
    one tensor on the first shard's device, copied to another device
    where a shard reads it.

The rules are the reference's (`distributed/sharding.py`), copied leaf
for leaf, and return the same specs: a tuple with ``"model"`` at the
split dim and None elsewhere, right-aligned like a PartitionSpec, so a
stacked reference leaf's spec is the port's per-layer leaf's with a
leading None.

Training adds the batch axes (`batch_axes`: ``pod``, ``data``): each data
replica holds its own copy of the params (its ``model`` stripes,
`replica_params`) and runs its slice of the batch (`split_batch`), and
the optimizer's moments are cut once more over ``data`` (`zero1_pspec`,
`TrainSharding`). Everything stays under one controller, as in the
reference: a multi-process run (``torch.distributed``) needs more than
one card and is not part of the port.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.packing import PACK, PackedLinear
from repro_torch.core.quantize import QuantConfig
from repro_torch.utils.tree import map_tree, map_with_path


class Mesh:
    """Devices on a grid with named axes: ``axis_names``, ``shape`` (axis
    name → size) and ``devices`` (an object array of `torch.device`, one
    dim per axis). Several shards may share a device (the card phases
    co-locate two or four on ``cuda:0``)."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))


def model_devices(mesh: Mesh) -> list[torch.device]:
    """The devices along the ``model`` axis of the first data replica
    (`replica_meshes`), in shard order. Serving runs on that one stripe:
    the reference's rules (`param_pspec`, `paged_cache_pspec`) name no
    ``data`` or ``pod`` axis, so GSPMD replicates every operand over them
    and its other replicas compute the same bytes; the port computes them
    once."""
    return list(replica_meshes(mesh)[0].devices)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes that jointly carry the batch (DP) dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    """The number of data replicas: the product of the batch axes."""
    return int(np.prod([mesh.shape[a] for a in batch_axes(mesh)]))


def replica_meshes(mesh: Mesh) -> list[Mesh]:
    """One ``('model',)`` mesh a data replica, replicas in the batch axes'
    order (``pod`` major): replica r holds batch slice r."""
    names = list(mesh.axis_names)
    dev = mesh.devices
    if "model" not in names:
        dev, names = dev[..., None], names + ["model"]
    order = [names.index(a) for a in names if a != "model"] \
        + [names.index("model")]
    grid = np.transpose(dev, order).reshape(-1, dev.shape[names.index(
        "model")])
    return [Mesh(list(row), ("model",)) for row in grid]


def serving_mesh(model: int | None = None, devices=None) -> Mesh:
    """A 1-D ``('model',)`` mesh over the first ``model`` devices.

    ``devices`` defaults to this machine's CUDA cards; asking for more
    shards than there are raises, as the reference's does (``model=None``
    takes them all). An explicit ``devices`` list may repeat a device:
    that is how shards share one card (or the CPU) — nothing wraps
    around on its own."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if model is None else model
    if n < 1 or n > len(devices):
        raise ValueError(f"serving_mesh(model={model}): have "
                         f"{len(devices)} devices")
    return Mesh(devices[:n], ("model",))


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-based), the reference's
# ---------------------------------------------------------------------------

# Column-parallel (shard output/N dim) vs row-parallel (shard input/K dim).
_COL_LINEARS = ("wq", "wk", "wv", "gate", "up", "wz", "wx", "wb", "wc",
                "wdt", "q_proj", "kv_down", "kv_up", "patch_proj",
                "frame_proj")
_ROW_LINEARS = ("wo", "down", "out_proj")


def _linear_axes(parent: str, k: int, n: int, mesh: Mesh, cfg=None
                 ) -> tuple[str | None, str | None]:
    """(K-axis, N-axis) sharding for a linear named ``parent``."""
    msize = mesh.shape.get("model", 1)
    if parent in _ROW_LINEARS:
        return ("model" if k % msize == 0 else None), None
    if parent in _COL_LINEARS:
        # attention projections shard only when whole heads land on a shard
        if cfg is not None and parent in ("wq", "wk", "wv"):
            heads = cfg.num_heads if parent == "wq" else cfg.num_kv_heads
            if heads % msize != 0:
                return None, None
        return None, ("model" if n % msize == 0 else None)
    return None, None


def _pad(shape: tuple, tail: list) -> tuple:
    return (None,) * (len(shape) - len(tail)) + tuple(tail)


def param_pspec(path: str, leaf: Any, mesh: Mesh, cfg=None) -> tuple:
    """Spec of one param leaf addressed by its tree path (float linears
    ``.../<name>/w``, `PackedLinear` fields ``.../<name>/qweight`` etc.,
    embeddings, norms). A packed row-parallel linear whose K-shard would
    not hold whole quant groups flips to column-parallel; a packed
    linear's ``bias`` has no rule (replicated), as in the reference."""
    shape = tuple(leaf.shape)
    parts = path.split("/")
    leafname = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    msize = mesh.shape.get("model", 1)

    if "embed" in path and leafname == "table":
        v, d = shape[-2], shape[-1]
        if v % msize == 0:
            return _pad(shape, ["model", None])
        if d % msize == 0:
            return _pad(shape, [None, "model"])
        return (None,) * len(shape)

    if parent == "lm_head" and leafname == "w":
        return _pad(shape, [None, "model" if shape[-1] % msize == 0
                            else None])

    if parent == "experts" or (len(parts) >= 3 and parts[-3] == "experts"):
        # experts/<gate|up|down>/w with shape [..., E, K, N]
        name = parent if leafname == "w" else parts[-2]
        if leafname in ("w", "qweight", "scales", "zeros"):
            if name in ("gate", "up"):
                ax = "model" if shape[-1] % msize == 0 else None
                return _pad(shape, [None, None, ax])
            if name == "down":
                if leafname == "w":   # float (training): row-parallel on F
                    ax = "model" if shape[-2] % msize == 0 else None
                    return _pad(shape, [None, ax, None])
                # packed (serving): an F-split would cut quant groups, so
                # the output dim D splits instead
                ax = "model" if shape[-1] % msize == 0 else None
                return _pad(shape, [None, None, ax])
        # input_scale stays whole: it scales the gathered input
        return (None,) * len(shape)

    if leafname in ("w", "qweight", "scales", "zeros") and len(shape) >= 2:
        k_ax, n_ax = _linear_axes(parent, shape[-2], shape[-1], mesh, cfg)
        if leafname != "w" and k_ax is not None:
            # a K-shard must hold whole dequant groups (the AWQ_MACRO
            # invariant), else the linear flips to column-parallel
            gs = (getattr(cfg, "quant_group_size", None)
                  or QuantConfig().group_size)
            k_full = shape[-2] * (PACK if leafname == "qweight" else gs)
            if (k_full // msize) % gs != 0:
                k_ax = None
                n_ax = "model" if shape[-1] % msize == 0 else None
        if k_ax and shape[-2] % msize != 0:
            k_ax = None
        return _pad(shape, [k_ax, n_ax])

    if leafname == "input_scale":
        k_ax, _ = _linear_axes(parent, shape[-1], 0, mesh, cfg)
        return _pad(shape, [k_ax if shape[-1] % msize == 0 else None])

    if leafname == "b" and len(parts) >= 2:
        _, n_ax = _linear_axes(parent, 0, shape[-1], mesh, cfg)
        return _pad(shape, [n_ax if shape[-1] % msize == 0 else None])

    return (None,) * len(shape)  # norms, scalars, ...


def zero1_pspec(pspec: tuple, shape: tuple, mesh: Mesh) -> tuple:
    """ZeRO-1: an optimizer moment's spec, cut once more over ``data``:
    its first dim that the param's spec leaves whole and ``|data|``
    divides takes ``"data"`` (the reference's rule)."""
    dsize = mesh.shape.get("data", 1)
    if dsize == 1:
        return tuple(pspec)
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (ax, dim) in enumerate(zip(spec, shape)):
        if ax is None and dim % dsize == 0 and dim >= dsize:
            spec[i] = "data"
            return tuple(spec)
    return tuple(spec)


def paged_cache_pspec(path: str, leaf: Any, mesh: Mesh, cfg=None) -> tuple:
    """Spec of a serving page-pool leaf: codes ``[N, P, Hkv, hd]`` and
    scale strips ``[N, P, Hkv]`` stripe over KV heads; page ids index the
    unsplit leading dim, so the host pager stays device-agnostic. Head
    counts that do not divide fall back to replication (the engine
    refuses such meshes first); per-slot state is replicated."""
    shape = tuple(leaf.shape)
    leafname = path.split("/")[-1]
    msize = mesh.shape.get("model", 1)
    if leafname in ("k", "v") and len(shape) >= 2 and shape[-2] % msize == 0:
        return _pad(shape, ["model", None])
    if leafname in ("ks", "vs") and shape and shape[-1] % msize == 0:
        return _pad(shape, ["model"])
    return (None,) * len(shape)


# ---------------------------------------------------------------------------
# Logical axes and the one-shot decode cache's rule (SP-decode)
# ---------------------------------------------------------------------------

# Logical activation axes → mesh axes, the reference's. Several logical
# names map to the same mesh axis ("model"); `_resolve` allocates greedily
# in dimension order and never assigns one mesh axis twice.
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "q_groups": ("model",),
    "ffn": ("model",),
    "vocab": ("model",),
    "cache_seq": ("model",),
    "seq": ("model",),       # sequence parallelism (long-context prefill)
    "model": ("model",),
    "expert_cap": ("pod", "data"),
    "ssm_inner": ("model",),
}


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _resolve(mesh: Mesh, logical: tuple, shape: tuple) -> tuple:
    """Logical axes → a spec tuple (an entry: None, a mesh axis, or a
    tuple of mesh axes). Drops axes that are absent from the mesh, do not
    divide the dimension, or were assigned to an earlier dimension (first
    match wins), as the reference's."""
    out = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in LOGICAL_RULES.get(name, (name,))
                     if a in mesh.axis_names and a not in used)
        if axes and dim % _axis_size(mesh, axes) == 0:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def cache_pspec(path: str, leaf: Any, mesh: Mesh, cfg=None) -> tuple:
    """Spec of a one-shot decode cache leaf (the reference's rule): the
    batch over ``(pod, data)``; k / v ``[B, S, Hkv, hd]`` over ``model``
    along S (SP-decode) when ``S % |model| == 0`` and ``S >= 8 |model|``,
    else over the kv heads; their int8 scale strips ``ks`` / ``vs``
    ``[B, S, Hkv]`` and MLA's latents ``ckv`` / ``kpe`` ``[B, S, R]``
    along S under the same test; conv caches ``[B, d_conv, C]`` over
    channels; SSM states ``[B, nh, hd, ds]`` over heads (each only where
    the mesh axis divides)."""
    shape = tuple(leaf.shape)
    leafname = path.split("/")[-1]
    msize = mesh.shape.get("model", 1)

    def full(tail: list) -> tuple:
        lead = [None] * (len(shape) - len(tail))
        return _resolve(mesh, tuple(lead + tail), shape)

    if leafname in ("k", "v"):
        s_dim, h_dim = shape[-3], shape[-2]
        if s_dim % msize == 0 and s_dim >= 8 * msize:
            return full(["batch", "model", None, None])
        if h_dim % msize == 0:
            return full(["batch", None, "model", None])
        return full(["batch", None, None, None])
    if leafname in ("ks", "vs", "ckv", "kpe"):
        s_dim = shape[-2]
        if s_dim % msize == 0 and s_dim >= 8 * msize:
            return full(["batch", "model", None])
        return full(["batch", None, None])
    if leafname.startswith("conv"):
        return full(["batch", None, "model"])
    if leafname == "state":
        return full(["batch", "model", None, None])
    return full(["batch", None])


def _place_leaves(cache: Any, mesh: Mesh, keep) -> Any:
    """Every leaf of a decode cache that `cache_pspec` splits over
    ``model`` and ``keep(name, dim)`` admits becomes a list of ``|model|``
    pieces (contiguous, one a shard, on its device, in shard order);
    every other leaf stays whole on the first shard's device."""
    devices = model_devices(mesh)

    def one(path, leaf):
        dim = split_dim(cache_pspec(path, leaf, mesh))
        if dim is not None and keep(path.split("/")[-1], dim):
            return _shard_leaf(leaf, leaf.dim() + dim, devices)
        return leaf.to(devices[0])
    return map_with_path(one, cache)


def shard_cache(cache: Any, mesh: Mesh) -> Any:
    """A one-shot decode cache (`Model.init_cache`) for SP-decode under
    whole parameters: every attention leaf that `cache_pspec` stripes
    along S becomes a list of ``|model|`` sequence stripes; every other
    leaf, and everything off the ``model`` axis (the reference replicates
    over ``data``), stays whole on the first shard's device. The S-only
    case of `place_cache`: `Model.decode_step` / `prefill` without a
    mesh read and write such a cache."""
    return _place_leaves(cache, mesh, lambda name, dim: name in (
        "k", "v", "ks", "vs") and dim == (-3 if name in ("k", "v") else -2))


def place_cache(cache: Any, mesh: Mesh) -> Any:
    """A one-shot decode cache placed leaf by leaf as `cache_pspec` says,
    for `Model.prefill` / `decode_step` under ``mesh``: k / v along S
    (SP-decode) or over kv heads, ``ks`` / ``vs`` and MLA's ``ckv`` /
    ``kpe`` along S, conv caches over channels, SSM states over heads;
    a split leaf is a list of ``|model|`` pieces, one a shard on its
    device, and a leaf the rule leaves whole stays on the first shard's
    device. A mesh of several data replicas gives one such cache a
    replica (`replica_meshes` order), replica r holding rows ``[r·B/n,
    (r+1)·B/n)``, the rows `split_batch` hands it (B must divide)."""
    reps = replica_meshes(mesh)
    if len(reps) == 1:
        return _place_leaves(cache, mesh, lambda name, dim: True)
    n = len(reps)
    b = _first_leaf(cache).shape[0]
    if b % n:
        raise ValueError(f"a cache of {b} rows does not split over {n} "
                         f"data replicas")
    return [_place_leaves(map_tree(lambda t, _r=r: t.narrow(
        0, _r * (b // n), b // n).clone(), cache), rm,
        lambda name, dim: True) for r, rm in enumerate(reps)]


def _first_leaf(tree: Any) -> torch.Tensor:
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def join_cache(placed: Any, mesh: Mesh, like: Any) -> Any:
    """The logical cache of a `place_cache` (or `shard_cache`) cache:
    each split leaf's pieces joined along the dim `cache_pspec` splits on
    ``like`` (the logical cache, or its ``meta`` layout), a data
    replica's rows after the one before, on the mesh's first device."""
    reps = replica_meshes(mesh)
    dev = model_devices(mesh)[0]
    if len(reps) > 1:
        rows = _first_leaf(like).shape[0] // len(reps)
        part = map_tree(lambda t: t.narrow(0, 0, rows), like)
        joined = [join_cache(c, rm, part) for c, rm in zip(placed, reps)]
        return map_tree(lambda *ts: torch.cat([t.to(dev) for t in ts]),
                        *joined)

    def walk(node, ref, path):
        if isinstance(node, dict):
            return {k: walk(v, ref[k], f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(ref, list):
            return [walk(v, r, path) for v, r in zip(node, ref)]
        if isinstance(node, list):
            dim = split_dim(cache_pspec(path, ref, mesh))
            return torch.cat([t.to(dev) for t in node], dim=dim)
        return node.to(dev)
    return walk(placed, like, "")


def split_dim(spec: tuple, axis: str = "model") -> int | None:
    """The (negative) dim a spec splits over ``axis``, or None."""
    return (spec.index(axis) - len(spec)) if axis in spec else None


# ---------------------------------------------------------------------------
# Tree helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): where each dim
    of a leaf splits. `shard_shape` gives one device's piece."""
    mesh: Mesh
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape of one device's piece of a leaf of ``shape``."""
        shape = tuple(shape)
        spec = (None,) * (len(shape) - len(self.spec)) + tuple(self.spec)
        return tuple(d // _axis_size(self.mesh, ax)
                     for d, ax in zip(shape, spec))


def _walk_specs(tree: Any, fn, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists of layers (no index
    in the path, as `utils.tree.map_with_path`) and `PackedLinear`s (a
    field's path ``.../<linear>/<field>``; the node becomes a dict of its
    fields' results), keeping the structure."""
    if isinstance(tree, dict):
        return {k: None if v is None
                else _walk_specs(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk_specs(v, fn, path) for v in tree]
    if isinstance(tree, PackedLinear):
        return {f: fn(f"{path}/{f}", getattr(tree, f))
                for f in ("qweight", "scales", "zeros", "input_scale",
                          "bias") if getattr(tree, f) is not None}
    return fn(path, tree)


def pspec_tree(tree: Any, mesh: Mesh, rule, cfg=None) -> Any:
    """``rule(path, leaf, mesh, cfg)`` over a tree: its spec tuples in the
    tree's structure (a `PackedLinear` becomes a dict of its fields')."""
    return _walk_specs(tree, lambda p, x: rule(p, x, mesh, cfg))


def make_sharding(tree: Any, mesh: Mesh, rule, cfg=None) -> Any:
    """`pspec_tree` with each spec as a `NamedSharding` on ``mesh``."""
    return _walk_specs(tree, lambda p, x: NamedSharding(
        mesh, rule(p, x, mesh, cfg)))


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _shard_leaf(t: torch.Tensor, dim: int | None,
                devices: list[torch.device], copy: bool = False
                ) -> list[torch.Tensor]:
    """One piece a shard: a fresh contiguous allocation for a split leaf
    (zeros for a ``meta`` leaf: a pool laid out without storage), the
    leaf itself (moved; with ``copy``, a copy of its own) for a
    replicated one."""
    n = len(devices)
    if dim is None:
        if t.device.type == "meta":
            return [torch.zeros(t.shape, dtype=t.dtype, device=d)
                    for d in devices]
        return [t.to(d, copy=copy) for d in devices]
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    size = t.shape[dim] // n
    out = []
    for s, d in enumerate(devices):
        piece = t.narrow(dim, s * size, size)
        buf = torch.zeros(piece.shape, dtype=t.dtype, device=d) \
            if t.device.type == "meta" else \
            torch.empty(piece.shape, dtype=t.dtype, device=d).copy_(piece)
        out.append(buf)
    return out


def shard_tree(tree: Any, mesh: Mesh, rule, cfg=None,
               copy: bool = False) -> list:
    """One tree a shard of the ``model`` axis: every tensor leaf placed by
    ``rule(path, leaf, mesh, cfg)`` (`param_pspec` or
    `paged_cache_pspec`); dicts, lists and `PackedLinear`s keep their
    structure (a split `PackedLinear` records ``shards = n``). With
    ``copy`` every shard's leaf has storage of its own (training updates
    each replica's leaves; serving shares a replicated leaf)."""
    devices = model_devices(mesh)
    n = len(devices)

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            return _shard_leaf(node, split_dim(rule(path, node, mesh, cfg)),
                               devices, copy)
        if isinstance(node, dict):
            kids = {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
            return [{k: v[s] for k, v in kids.items()} for s in range(n)]
        if isinstance(node, list):
            kids = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return [[v[s] for v in kids] for s in range(n)]
        if isinstance(node, PackedLinear):
            fields = {f: walk(getattr(node, f), f"{path}/{f}")
                      for f in ("qweight", "scales", "zeros", "input_scale",
                                "bias") if getattr(node, f) is not None}
            split = any(split_dim(rule(f"{path}/{f}", getattr(node, f), mesh,
                                       cfg)) is not None for f in fields)
            return [dataclasses.replace(
                node, **{f: v[s] for f, v in fields.items()},
                shards=n if split else 1) for s in range(n)]
        return [node] * n

    return walk(tree, "")


def shard_params(params: dict, mesh: Mesh, cfg=None,
                 copy: bool = False) -> list[dict]:
    """`shard_tree` of a params tree under `param_pspec`, made runnable
    shard by shard: where a `PackedLinear`'s words split over N but the
    rule leaves its ``scales`` / ``zeros`` / ``bias`` whole (a K/GS or
    bias it does not cut, as in the reference, whose GSPMD slices them in
    place), each shard keeps its own columns of them."""
    shards = shard_tree(params, mesh, param_pspec, cfg, copy)

    def fix(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            for k in first:
                fix([t[k] for t in nodes])
        elif isinstance(first, list):
            for i in range(len(first)):
                fix([t[i] for t in nodes])
        elif isinstance(first, PackedLinear):
            for s, p in enumerate(nodes):
                for f in ("scales", "zeros", "bias"):
                    t = getattr(p, f)
                    if t is not None and t.shape[-1] != p.n:
                        setattr(p, f, t.narrow(-1, s * p.n, p.n).contiguous())

    fix(shards)
    return shards


def replica_params(params: dict, mesh: Mesh, cfg=None) -> list[list]:
    """A ``(data, model)`` mesh's params: one list of ``model``-shard
    trees (`shard_params`) a data replica (`replica_meshes`), every leaf
    of every shard its own allocation, so a replica's in-place change
    never reaches another's."""
    return [shard_params(params, rm, cfg, copy=True)
            for rm in replica_meshes(mesh)]


def split_batch(batch: dict, mesh: Mesh) -> list[dict]:
    """A batch cut over the batch axes: replica r's rows ``[r·B/n,
    (r+1)·B/n)`` of every leaf, on that replica's first device (the
    reference's grouped dispatch takes the same contiguous groups). B
    must divide."""
    n = dp_size(mesh)
    rms = replica_meshes(mesh)
    out = [{} for _ in rms]
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {n} data replicas")
        size = v.shape[0] // n
        for r, rm in enumerate(rms):
            out[r][k] = v[r * size:(r + 1) * size].to(rm.devices[0])
    return out


def narrow_piece(t: torch.Tensor, dim: int | None, i: int,
                 n: int) -> torch.Tensor:
    """Piece i of n of ``t`` along ``dim`` (a contiguous copy), or ``t``."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


def join_pieces(parts: list, dim: int | None, device) -> torch.Tensor:
    """The pieces joined along ``dim`` in order on ``device`` (the first
    piece, moved, when ``dim`` is None)."""
    if dim is None:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


class MeshTrainState(dict):
    """A train state on a mesh: ``params`` (`replica_params`: a list a
    data replica of its ``model`` shards' trees), ``opt`` ``{"m", "v"}``
    of the same layout whose leaves are ZeRO-1 slices (`zero1_pspec`:
    replica r holds slice ``r mod |data|`` of its stripe's moments), and
    ``step``. ``sharding`` (`TrainSharding`) and ``specs`` (each leaf's
    ``(model dim, ZeRO-1 data dim)``, read on the logical leaves) map it
    back to the logical state (`logical`), which is what a checkpoint
    holds."""

    def __init__(self, state: dict, sharding: "TrainSharding", specs):
        super().__init__(state)
        self.sharding, self.specs = sharding, specs

    def logical(self) -> dict:
        return self.sharding.gather(self)


@dataclasses.dataclass(frozen=True)
class TrainSharding:
    """Where a train state lives on a ``(data, model)`` (or ``(pod, data,
    model)``) mesh: params split by `param_pspec` and copied to every
    data replica, moments cut once more by `zero1_pspec`. The rules are
    read on each layer's own leaf: where the reference's scan-stacked
    leaf gives ``data`` to its layer dim, the port's layer leaf gives it
    to its first free dim that divides (each replica still holds 1 /
    |data| of every moment)."""
    mesh: Mesh
    cfg: Any = None

    @property
    def replicas(self) -> list[Mesh]:
        return replica_meshes(self.mesh)

    @property
    def data_size(self) -> int:
        return self.mesh.shape.get("data", 1)

    def specs(self, params) -> Any:
        """``(model dim, ZeRO-1 data dim)`` a leaf of the logical
        ``params`` (each None or a negative dim), in their structure."""
        def one(path, leaf):
            spec = param_pspec(path, leaf, self.mesh, self.cfg)
            z = zero1_pspec(spec, tuple(leaf.shape), self.mesh)
            return (split_dim(spec), split_dim(z, "data"))
        return map_with_path(one, params)

    def place(self, state: dict) -> MeshTrainState:
        """A logical train state (``params``, ``opt``, ``step``) on the
        mesh."""
        specs = self.specs(state["params"])
        dn = self.data_size
        opt = {}
        for key in ("m", "v"):
            opt[key] = []
            for r, rm in enumerate(self.replicas):
                stripes = shard_tree(state["opt"][key], rm, param_pspec,
                                     self.cfg, copy=True)
                opt[key].append([map_tree(
                    lambda t, sp, _m=m: None if sp[0] is None and _m
                    else narrow_piece(t, sp[1], r % dn, dn), st, specs)
                    for m, st in enumerate(stripes)])
        return MeshTrainState({
            "params": replica_params(state["params"], self.mesh, self.cfg),
            "opt": opt,
            "step": state["step"].to(self.mesh.devices.flat[0], copy=True)},
            self, specs)

    def gather(self, state: dict) -> dict:
        """The logical state of a `MeshTrainState` (replica 0's params; the
        moments' slices and stripes joined), on the mesh's first
        device."""
        dev = self.mesh.devices.flat[0]
        specs = state.specs
        dn = self.data_size

        def params_of(shards):
            return map_tree(lambda sp, *ts: join_pieces(list(ts), sp[0], dev),
                            specs, *shards)
        opt = {}
        for key in ("m", "v"):
            grid = state["opt"][key]
            stripes = [map_tree(lambda sp, *sl: None if sl[0] is None
                                else join_pieces(list(sl), sp[1], dev),
                                specs, *[grid[r][m] for r in range(dn)])
                       for m in range(len(grid[0]))]
            opt[key] = params_of(stripes)
        return {"params": params_of(state["params"][0]), "opt": opt,
                "step": state["step"].to(dev)}


# ---------------------------------------------------------------------------
# Collectives: explicit, in shard order
# ---------------------------------------------------------------------------

# The HLO collective kind each explicit collective stands for, as the
# reference's roofline counts its compiled program: a row-parallel sum is
# an all-reduce, a join of the shards' pieces an all-gather; handing each
# shard its piece of a tensor held on one device (`split`, a strip
# entering the mesh) has no SPMD counterpart (there the operand is already
# resident) and counts as ``scatter``.
COLLECTIVE_KINDS = {"all_sum": "all-reduce", "concat": "all-gather",
                    "split": "scatter", "grad_reduce": "all-reduce",
                    "zero1_gather": "all-gather",
                    "int8_reduce": "all-reduce"}


@dataclasses.dataclass
class CollectiveCounter:
    """What the explicit collectives moved while a `count_collectives`
    block ran: calls and operand bytes a device, by collective
    (``by_op``, the keys of `COLLECTIVE_KINDS`) and by HLO kind
    (`by_kind`). A device's operand is its own piece: a partial for
    `all_sum`, its piece for `concat` / `split`, its gradient (in the
    wire type) for the data axis's reduction, its slice for ZeRO-1's
    gather. The first device's: where the data replicas run the same
    work (`replica_share`), each replica's call counts its share. What
    autograd moves between shards in a backward (copies, not these
    functions) is not counted."""
    calls: dict = dataclasses.field(default_factory=dict)
    by_op: dict = dataclasses.field(default_factory=dict)
    share: float = 1.0

    def add(self, op: str, nbytes: float) -> None:
        self.calls[op] = self.calls.get(op, 0) + self.share
        self.by_op[op] = self.by_op.get(op, 0) + nbytes * self.share

    @property
    def by_kind(self) -> dict:
        out = {k: 0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                              "all-to-all", "collective-permute",
                              "scatter")}
        for op, b in self.by_op.items():
            out[COLLECTIVE_KINDS[op]] += b
        return out

    @property
    def total(self) -> float:
        return sum(self.by_op.values())


_COUNTER: CollectiveCounter | None = None


@contextlib.contextmanager
def count_collectives():
    """Count the explicit collectives' operand bytes a device inside the
    block (a `CollectiveCounter`); outside one nothing is counted, so
    serving and training pay one global read a collective."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, CollectiveCounter()
    try:
        yield _COUNTER
    finally:
        _COUNTER = prev


@contextlib.contextmanager
def replica_share(replicas: int):
    """A block that runs ``replicas`` data replicas' identical work (a
    mesh train step's forward and backward, remat's recomputation
    included): a device takes part only in its own replica's collectives,
    so each counts ``1 / replicas`` of a call."""
    if _COUNTER is None:
        yield
        return
    prev = _COUNTER.share
    _COUNTER.share = prev / replicas
    try:
        yield
    finally:
        _COUNTER.share = prev


def record_collective(op: str, t: torch.Tensor | float) -> None:
    """Count one collective (a key of `COLLECTIVE_KINDS`) whose operand on
    each device is ``t`` (a tensor, or its bytes) when counting is on."""
    if _COUNTER is not None:
        _COUNTER.add(op, t if isinstance(t, (int, float))
                     else t.numel() * t.element_size())


def all_sum(parts: list[torch.Tensor], devices: list[torch.device]
            ) -> torch.Tensor:
    """Σ parts in shard order 0 … n−1, on the first shard's device."""
    if len(parts) > 1:
        record_collective("all_sum", parts[0])
    acc = parts[0].to(devices[0])
    for p in parts[1:]:
        acc = acc + p.to(devices[0])
    return acc


def concat(parts: list[torch.Tensor], dim: int,
           devices: list[torch.device]) -> torch.Tensor:
    """The shards' pieces joined along ``dim`` in shard order, on the
    first shard's device."""
    if len(parts) == 1:
        return parts[0].to(devices[0])
    record_collective("concat", parts[0])
    return torch.cat([p.to(devices[0]) for p in parts], dim=dim)


def split(t: torch.Tensor, dim: int, devices: list[torch.device]
          ) -> list[torch.Tensor]:
    """``t`` cut into one contiguous piece a shard along ``dim``, each on
    its shard's device (the inverse of `concat`)."""
    n = len(devices)
    size = t.shape[dim] // n
    out = [t.narrow(dim, s * size, size).to(d).contiguous()
           for s, d in enumerate(devices)]
    if n > 1:
        record_collective("split", out[0])
    return out


def strip_gather(parts: list[torch.Tensor], dim: int | None,
                 devices: list[torch.device]) -> torch.Tensor:
    """A spill or handoff strip leaving the mesh: the shards' pieces of
    one pool leaf's pages joined over KV heads (``dim`` from
    `paged_cache_pspec`), so the host tier and the wire image hold one
    whole, mesh-agnostic copy (the reference's `spill_sharding` /
    `handoff_sharding`: replicated out of the mesh)."""
    return parts[0].to(devices[0]) if dim is None \
        else concat(parts, dim, devices)


def strip_scatter(strip: torch.Tensor, dim: int | None,
                  devices: list[torch.device]) -> list[torch.Tensor]:
    """A whole strip entering the mesh, re-striped over KV heads: each
    shard gets its heads' piece on its device (the same strip adopts on
    any mesh, or none)."""
    if dim is None:
        return [strip.to(d) for d in devices]
    return split(strip, dim, devices)
