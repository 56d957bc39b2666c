"""Activation-aware Weight Quantization (AWQ) — the paper's software layer.

AWQ (Lin et al., MLSys'24; used directly by the reproduced paper, §III-A)
finds the ~1% of weight channels that are *salient* by the magnitude of
the **activations** that multiply them, and protects them with a
per-input-channel scale ``s`` before round-to-nearest group quantization:

    W'[k, n] = W[k, n] * s[k]          (weights scaled UP on salient channels)
    x'[k]    = x[k] / s[k]             (activations scaled DOWN, foldable)

The scale is searched per linear over a one-parameter family

    s = act_mean ** alpha / w_max ** (1 - alpha)   (normalized),
    alpha ∈ {0, 1/n_grid, ..., (n_grid - 1)/n_grid},

minimizing ``|| X @ W − (X / s) @ Q(W · s) ||²`` on calibration rows — the
AutoAWQ search, as the reference runs it. The reference maps the loss over
the grid with ``vmap``; here the whole grid is one batched tensor op
(``[n_grid, K, N]`` fake-quantized weights, one batched matmul), on the
device the weight lives on.

The quantized linear keeps ``1/s`` as an explicit ``input_scale`` vector
applied at runtime (`core/qlinear.py`); `fold_into_norm` folds it into a
preceding norm's gain instead, with identical numerics.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.quantize import QuantConfig, fake_quantize
from repro_torch.numerics import matmul_f32


@dataclasses.dataclass(frozen=True)
class AWQConfig:
    """Search hyper-parameters for the activation-aware scale search."""

    quant: QuantConfig = QuantConfig()
    n_grid: int = 20          # alpha grid resolution (AutoAWQ default)
    max_calib_rows: int = 512  # activation rows kept per linear for the search
    duo_scaling: bool = True   # also weigh by 1/w_max like AutoAWQ's v2 search
    eps: float = 1e-4


def activation_scale_candidates(act_mean: torch.Tensor, w: torch.Tensor,
                                cfg: AWQConfig) -> torch.Tensor:
    """All candidate per-channel scales ``[n_grid, K]`` for the alpha grid.

    ``act_mean`` is mean(|x|) per input channel, shape [K]; ``w`` is [K, N].
    """
    act = act_mean.to(torch.float32).clamp_min(cfg.eps)
    w_max = w.abs().amax(dim=1).to(torch.float32).clamp_min(cfg.eps)  # [K]
    alphas = (torch.arange(cfg.n_grid, dtype=torch.float32, device=w.device)
              / cfg.n_grid)[:, None]                                 # [G, 1]
    if cfg.duo_scaling:
        s = act[None] ** alphas / (w_max[None] ** (1.0 - alphas) + cfg.eps)
    else:
        s = act[None] ** alphas
    s = s / torch.sqrt(s.amax(dim=1, keepdim=True) * s.amin(dim=1, keepdim=True)
                       + cfg.eps)                     # normalize the range
    return s.clamp_min(cfg.eps)


def _search_loss(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                 qcfg: QuantConfig) -> torch.Tensor:
    """Reconstruction MSE of the scaled-quantized layer on calibration
    rows ``x [R, K]``, for one scale ``s [K]`` (→ scalar) or a grid of them
    ``s [G, K]`` (→ [G])."""
    w_q = fake_quantize(w * s[..., :, None], qcfg)        # [(G,) K, N]
    y_ref = matmul_f32(x, w)                              # [R, N]
    y_q = matmul_f32(x / s[..., None, :], w_q)            # [(G,) R, N]
    return ((y_ref - y_q) ** 2).mean(dim=(-2, -1))


def _calib_rows(x_sample, cfg: AWQConfig, device) -> torch.Tensor:
    x = torch.as_tensor(x_sample, device=device).to(torch.float32)
    return x[: cfg.max_calib_rows]


def search_awq_scale(x_sample, w: torch.Tensor,
                     cfg: AWQConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Grid-search the activation-aware scale for one linear.

    Args:
      x_sample: calibration activations [rows, K] (tensor or numpy).
      w:        weight [K, N]; the search runs on its device.
    Returns:
      (best_scale [K] float32, best_loss scalar).
    """
    x = _calib_rows(x_sample, cfg, w.device)
    wf = w.to(torch.float32)
    cands = activation_scale_candidates(x.abs().mean(dim=0), wf, cfg)
    losses = _search_loss(x, wf, cands, cfg.quant)
    best = torch.argmin(losses)
    return cands[best], losses[best]


def search_awq_scale_shared(x_samples: Sequence, ws: Sequence[torch.Tensor],
                            cfg: AWQConfig) -> torch.Tensor:
    """One shared scale for several linears fed by the same activation
    (e.g. q/k/v reading one post-norm hidden state, whose inverse scale is
    folded once into that producer). Loss = over the concatenated
    consumers."""
    x = _calib_rows(x_samples[0], cfg, ws[0].device)
    w_cat = torch.cat([w.to(torch.float32) for w in ws], dim=1)
    cands = activation_scale_candidates(x.abs().mean(dim=0), w_cat, cfg)
    return cands[torch.argmin(_search_loss(x, w_cat, cands, cfg.quant))]


def fold_into_norm(norm_gamma: torch.Tensor,
                   inv_s: torch.Tensor) -> torch.Tensor:
    """Fold the activation inverse-scale into a preceding (RMS/Layer)Norm:
    ``norm(x) * gamma`` feeding ``linear`` becomes ``norm(x) *
    (gamma * inv_s)`` — zero runtime cost, the same numerics as the
    explicit multiply."""
    return norm_gamma * inv_s.to(norm_gamma.dtype)
