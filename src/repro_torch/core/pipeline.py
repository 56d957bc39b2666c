"""Whole-model post-training quantization (PTQ) pipeline.

The paper's automated flow (§III-A), as the reference runs it:

    1. a calibration forward under `CalibrationCapture` (`Model.loss`),
    2. per linear: the AWQ scale search on its captured rows (`core.awq`),
    3. group-quantize the scaled weight, pack it (`PackedLinear`), keep
       the inverse activation scale as ``input_scale``.

Model params are nested dicts; linears are sub-dicts ``{"w": [K, N]}``
(plus optional ``"b"``). The port keeps one tensor per layer (lists under
``segments/seg_i``), so a layer's linear sits at
``segments/seg_i/<layer>/<path>``; its capture name is the reference's
``segments/seg_i/<path>@<layer>``. A MoE layer's routed experts are one
stacked linear ``{"w": [E, K, N]}``: each expert is quantized on its own
(capture name ``...@<layer>,<expert>``, which no forward records, so
they take RTN as in the reference) and packed into one `PackedLinear`
whose tensors carry the leading expert dim. Linears without captured
stats (or with ``calib=None``) fall back to plain round-to-nearest
(scale = 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.awq import AWQConfig, search_awq_scale
from repro_torch.core.calibration import LinearStats
from repro_torch.core.packing import (PACK, PackedLinear, pack_linear,
                                      packed_linear_nbytes)
from repro_torch.core.quantize import QuantConfig, quantize_groupwise

# Param-path substrings never quantized (AWQ convention: embeddings, norms,
# tiny routers and positional tables stay in high precision).
DEFAULT_EXCLUDE = ("embed", "norm", "router", "lm_head", "conv", "a_log",
                   "dt_bias", "ssm_d", "pos_", "scale", "patch_proj")


@dataclasses.dataclass
class PTQReport:
    """Bookkeeping from one `quantize_params` run."""

    quantized: list[str] = dataclasses.field(default_factory=list)
    skipped: list[str] = dataclasses.field(default_factory=list)
    calibrated: list[str] = dataclasses.field(default_factory=list)
    packed_bytes: int = 0          # byte-exact AWQ_MACRO size of quantized linears
    dense_bytes_fp16: int = 0      # fp16 size of the same linears

    @property
    def compression_ratio(self) -> float:
        if self.dense_bytes_fp16 == 0:
            return 1.0
        return self.packed_bytes / self.dense_bytes_fp16


def _is_linear(node: Any) -> bool:
    return (isinstance(node, dict) and "w" in node
            and isinstance(node["w"], torch.Tensor) and node["w"].dim() >= 2
            and all(k in ("w", "b") for k in node))


def _quantizable(path: str, node: dict, qcfg: QuantConfig,
                 exclude: tuple[str, ...]) -> bool:
    w = node["w"]
    k, n = w.shape[-2], w.shape[-1]
    if any(e in path.lower() for e in exclude):
        return False
    # N must tile into AWQ macros, whose channel width equals the int4
    # pack width along K (core/packing.PACK) — one source of truth.
    if k % qcfg.group_size or n % PACK:
        return False
    return k * n >= 16384  # skip tiny projections (paper keeps them on CPU)


def _quantize_2d(w: torch.Tensor, stats: LinearStats | None,
                 cfg: AWQConfig):
    """Returns (q, scales, zeros, input_scale [K]) for one [K, N] weight;
    the search and the quantization run on w's device."""
    k = w.shape[0]
    if stats is not None and stats.rows.shape[0] >= 8:
        s, _ = search_awq_scale(stats.rows, w, cfg)
    else:
        s = torch.ones(k, dtype=torch.float32, device=w.device)
    w_scaled = w.to(torch.float32) * s[:, None]
    q, scales, zeros = quantize_groupwise(w_scaled, cfg.quant)
    return q, scales, zeros, 1.0 / s


def _stack_packed(slices: list[PackedLinear], lead, bias) -> PackedLinear:
    """Per-expert `PackedLinear`s -> one whose tensors carry ``lead``."""
    def stack(f):
        t = torch.stack([getattr(p, f) for p in slices])
        return t.reshape(*lead, *t.shape[1:])
    return PackedLinear(qweight=stack("qweight"), scales=stack("scales"),
                        zeros=stack("zeros"), input_scale=stack("input_scale"),
                        bias=bias, group_size=slices[0].group_size)


def capture_name(path_parts: list[str]) -> str:
    """Param path → the reference's capture name: a layer's linear
    ``segments/seg_0/3/attn/wq`` is ``segments/seg_0/attn/wq@3``."""
    if (len(path_parts) > 3 and path_parts[0] == "segments"
            and path_parts[2].isdigit()):
        return "/".join(path_parts[:2] + path_parts[3:]) + f"@{path_parts[2]}"
    return "/".join(path_parts)


def quantize_params(params: Any,
                    calib: dict[str, LinearStats] | None = None,
                    cfg: AWQConfig | QuantConfig | None = None,
                    exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
                    select: Callable[[str], bool] | None = None,
                    ) -> tuple[Any, PTQReport]:
    """Replace every quantizable linear in ``params`` with a `PackedLinear`.

    Args:
      params: nested-dict model params (float), on any device.
      calib:  capture stats from `CalibrationCapture.stats` (None → RTN).
      cfg:    AWQ search + quant config (GS 64 int4 asymmetric by
              default); a bare `QuantConfig` means the default search.
      select: optional extra predicate on the linear's path.

    Returns (new_params, PTQReport); the report lists one path per layer.
    """
    if isinstance(cfg, QuantConfig):
        cfg = AWQConfig(quant=cfg)
    cfg = cfg or AWQConfig()
    calib = calib or {}
    report = PTQReport()

    def visit(node: Any, path_parts: list[str]) -> Any:
        path = "/".join(path_parts)
        if _is_linear(node):
            if not _quantizable(path, node, cfg.quant, exclude) or (
                    select is not None and not select(path)):
                report.skipped.append(path)
                return node
            w = node["w"]
            k, n = w.shape[-2:]
            name = capture_name(path_parts)
            if w.dim() == 2:
                st = calib.get(name)
                packed = pack_linear(*_quantize_2d(w, st, cfg), node.get("b"),
                                     cfg.quant)
                calibrated, n_lin = st is not None, 1
            else:               # stacked experts: one slice at a time
                sep = "," if "@" in name else "@"
                stats = [calib.get(f"{name}{sep}{e}")
                         for e in range(w[..., 0, 0].numel())]
                packed = _stack_packed(
                    [pack_linear(*_quantize_2d(w_e, st, cfg), None, cfg.quant)
                     for w_e, st in zip(w.reshape(-1, k, n), stats)],
                    w.shape[:-2], node.get("b"))
                calibrated = any(st is not None for st in stats)
                n_lin = len(stats)
            if calibrated:
                report.calibrated.append(path)
            report.quantized.append(path)
            report.packed_bytes += n_lin * packed_linear_nbytes(
                k, n, cfg.quant.group_size)
            report.dense_bytes_fp16 += n_lin * k * n * 2
            return packed
        if isinstance(node, dict):
            return {k2: visit(v, path_parts + [k2]) for k2, v in node.items()}
        if isinstance(node, list):
            return [visit(v, path_parts + [str(i)])
                    for i, v in enumerate(node)]
        return node

    return visit(params, []), report


def model_size_bytes(params: Any, quantized: bool,
                     cfg: QuantConfig | None = None,
                     exclude: tuple[str, ...] = DEFAULT_EXCLUDE) -> int:
    """Serialized model size: fp16 baseline vs AWQ_MACRO-packed (paper
    Table III). Baseline = every param in fp16; quantized = quantizable
    linears in byte-exact AWQ_MACRO format, everything else fp16."""
    cfg = cfg or QuantConfig()
    total = 0

    def visit(node: Any, path_parts: list[str]) -> None:
        nonlocal total
        path = "/".join(path_parts)
        if isinstance(node, PackedLinear):
            lead = node.qweight[..., 0, 0].numel()
            total += lead * packed_linear_nbytes(node.k, node.n,
                                                 node.group_size)
            if node.bias is not None:
                total += node.bias.numel() * 2
            return
        if _is_linear(node):
            w = node["w"]
            lead, k, n = w[..., 0, 0].numel(), w.shape[-2], w.shape[-1]
            if quantized and _quantizable(path, node, cfg, exclude):
                total += lead * packed_linear_nbytes(k, n, cfg.group_size)
            else:
                total += lead * k * n * 2
            if node.get("b") is not None:
                total += node["b"].numel() * 2
            return
        if isinstance(node, dict):
            for k2, v in node.items():
                visit(v, path_parts + [k2])
            return
        if isinstance(node, list):
            for i, v in enumerate(node):
                visit(v, path_parts + [str(i)])
            return
        if isinstance(node, torch.Tensor):
            total += node.numel() * 2

    visit(params, [])
    return total
