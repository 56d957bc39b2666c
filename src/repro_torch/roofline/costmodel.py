"""Analytic per-cell cost model and the disaggregated-serving split policy.

The reference package's `roofline/costmodel.py` without its HLO
analysis (the port imports nothing of it): `cell_costs` counts the
FLOPs and bytes of one train, prefill or decode step from the
architecture alone (full-attention, sliding-window, MLA, Mamba-2
SSD or hymba's attention ∥ SSD mixers; GLU, plain, MoE or no MLP; an
encoder's head over every frame of a prefill: a MoE layer
streams every routed expert's weights once a step and computes on the
top-k share of its tokens; an MLA layer's cache line is its latent,
kv_lora + rope values a token; a windowed layer reads ``min(window, S)``
positions; an SSM layer reads and writes its f32 state once a decode
step; a train step prices the backward and the optimizer as below),
`analytic_terms` turns one cell into seconds at the card's peaks, and
`disagg_report` turns them into the prefill/decode split that
`serving.disagg`'s ``handoff_min_tokens="auto"`` reads. As in the
reference, a prefill or train step prices a bidirectional (encoder)
layer's score work at the causal pair count ``S · ctx / 2``, and the
frontend projections are not counted.

Conventions:
  * activations bf16 (2B), scores/softmax f32 (4B),
  * weight-only quant: 0.5625 B/weight (INT4 + scales/zeros at GS=64,
    byte-exact AWQ_MACRO rate) for quantizable linears, fp16 for the rest,
  * training weight traffic per param: bf16 fwd read + remat re-read +
    bwd read (3×2B) + f32 grad write+read (8B) + Adam m/v read+write
    (16B) + f32 master read+write (8B) = 38 B; attention scores, the
    SSD's terms and the head ×3 for the backward, the logits written
    and read twice, and every FLOP ×4/3 for remat's extra forward,

The machine constants are the port's card, not the reference's TPU:
one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, dense bf16 tensor
cores and HBM bandwidth from NVIDIA's data sheet (the figures the
kernels' bounds use). At these constants the split report for
Qwen2.5-0.5B at small decode batches says not to disaggregate, so
``"auto"`` hands nothing off there.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import SHAPES, ShapeCell
from repro_torch.configs.base import ModelConfig

# NVIDIA H100 80GB HBM3 (SXM), 700 W: dense bf16 FLOP/s and HBM bytes/s
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12

AWQ_BYTES_PER_W = 4.5 / 8          # byte-exact AWQ_MACRO rate at GS=64
TRAIN_BYTES_PER_W = 38             # a trained weight's traffic a step
ACT = 2                            # bf16 activations
F32 = 4


def _linear_dims(cfg: ModelConfig, kind) -> list[tuple[int, int]]:
    """(K, N) of every linear in one block of this kind (a MoE layer's
    experts, shared experts and router come from `_moe_dims`)."""
    d = cfg.d_model
    dims: list[tuple[int, int]] = []
    if kind.mixer in ("attn", "hymba"):
        dims += [(d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim),
                 (cfg.q_dim, d)]
    if kind.mixer == "mla":
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dims += [(d, cfg.num_heads * (nope + rope)),
                 (d, cfg.kv_lora_rank + rope),
                 (cfg.kv_lora_rank, cfg.num_heads * (nope + cfg.v_head_dim)),
                 (cfg.num_heads * cfg.v_head_dim, d)]
    if kind.mixer in ("mamba", "hymba"):
        di, gd = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
        dims += [(d, di), (d, di), (d, gd), (d, gd), (d, cfg.ssm_nheads),
                 (di, d)]
    if kind.mlp == "glu":
        dims += [(d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    elif kind.mlp == "plain":
        dims += [(d, cfg.d_ff), (cfg.d_ff, d)]
    return dims


def _moe_dims(cfg: ModelConfig) -> tuple[list[tuple[int, int]],
                                         list[tuple[int, int]]]:
    """(per-routed-expert dims, shared / dense-path dims) for a MoE block."""
    d = cfg.d_model
    routed = [(d, cfg.moe_d_ff), (d, cfg.moe_d_ff), (cfg.moe_d_ff, d)]
    shared = []
    if cfg.num_shared_experts:
        sf = cfg.shared_d_ff
        shared = [(d, sf), (d, sf), (sf, d)]
    shared.append((d, cfg.num_experts))  # router
    return routed, shared


def _quantizable(k: int, n: int, gs: int = 64) -> bool:
    return k % gs == 0 and n % 8 == 0 and k * n >= 16384


@dataclasses.dataclass
class CellCosts:
    flops: float = 0.0             # executed matmul+attention flops, global
    weight_bytes: float = 0.0      # weight traffic per step, global
    act_bytes: float = 0.0         # activation/score materialization, global
    cache_bytes: float = 0.0       # KV cache traffic per step, global

    @property
    def total_bytes(self) -> float:
        return self.weight_bytes + self.act_bytes + self.cache_bytes


def cell_costs(cfg: ModelConfig, cell: ShapeCell, quant: bool) -> CellCosts:
    """Global per-step costs for one (arch × shape) cell: a train,
    prefill or decode step whose layers are attention (global or
    windowed), MLA, SSD or hymba mixers with GLU, plain, MoE or no MLPs
    (every registered architecture); an encoder's prefill and every
    train step run the head at every position. An encoder's decode
    cells raise `ValueError` with the words of the reference's
    ``skipped_cells``."""
    if cfg.is_encoder and cell.step == "decode":
        raise ValueError(f"{cfg.name}: encoder-only: no autoregressive "
                         f"decode step")
    b, s = cell.global_batch, cell.seq_len
    train = cell.step == "train"
    decode = cell.step == "decode"
    toks = b if decode else b * s
    c = CellCosts()
    # bytes a weight a step: a quantized linear streams its int4 words
    # (the reference's rule, in training too), the rest their bf16 copy,
    # or the whole train traffic
    wq_b = AWQ_BYTES_PER_W if quant else (2 if not train else
                                          TRAIN_BYTES_PER_W)
    wfp_b = 2 if not train else TRAIN_BYTES_PER_W

    def add_linear(k: int, n: int, tok: float, n_mats: float = 1.0):
        c.flops += 2.0 * k * n * tok * n_mats
        c.weight_bytes += k * n * n_mats * \
            (wq_b if (quant and _quantizable(k, n)) else wfp_b)
        c.act_bytes += tok * (k + n) * ACT

    for kind in cfg.layer_kinds():
        if kind.mlp == "moe":
            routed, shared = _moe_dims(cfg)
            for k, n in routed:
                # every expert's weights stream once per step; compute
                # only on the top_k-dispatched share of tokens
                add_linear(k, n, toks * cfg.top_k / cfg.num_experts,
                           n_mats=cfg.num_experts)
            for k, n in shared:
                add_linear(k, n, toks)
        for k, n in _linear_dims(cfg, kind):
            add_linear(k, n, toks)

        if kind.mixer in ("attn", "hymba", "mla"):
            _attention_costs(c, cfg, kind, b, s, cell.step)
        if kind.mixer in ("mamba", "hymba"):
            nh, hd, ds = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
            if decode:
                c.cache_bytes += 2.0 * b * nh * hd * ds * F32  # state rw
                c.flops += 2.0 * 3 * b * nh * hd * ds
            else:
                q = min(cfg.ssm_chunk, s)
                factor = 3.0 if train else 1.0
                # intra-chunk quadratic + state build/apply
                c.flops += (2.0 * b * s * q * nh * (ds + hd) / 2
                            + 4.0 * b * s * nh * hd * ds) * factor
                c.act_bytes += b * s * nh * (hd + 2 * ds) * F32 * factor

    # --- embeddings / head (at every position of an encoder or a train
    # step; an untied head's table counted once for an encoder, as the
    # reference counts it) / loss ---
    v, d = cfg.vocab_size, cfg.d_model
    c.weight_bytes += v * d * wfp_b * (2 if not cfg.tie_embeddings
                                       and not cfg.is_encoder else 1)
    head_toks = toks if (train or cfg.is_encoder) else b
    c.flops += 2.0 * v * d * head_toks * (3.0 if train else 1.0)
    c.act_bytes += head_toks * v * F32 * (2.0 if train else 1.0)  # logits
    if train:
        c.flops *= 4.0 / 3.0       # remat: one extra forward of everything
    return c


def analytic_terms(cfg: ModelConfig, cell: str | ShapeCell, chips: int,
                   quant: bool) -> dict:
    """One cell's FLOPs and bytes (`cell_costs`) and their seconds at the
    card's peaks over ``chips`` cards: ``cell`` names a `SHAPES` cell, as
    in the reference, or is an ad-hoc `ShapeCell` (a train step at the
    batch a run takes)."""
    cc = cell_costs(cfg, SHAPES[cell] if isinstance(cell, str) else cell,
                    quant)
    return {
        "analytic_flops_global": cc.flops,
        "analytic_bytes_global": cc.total_bytes,
        "analytic_weight_bytes": cc.weight_bytes,
        "analytic_act_bytes": cc.act_bytes,
        "analytic_cache_bytes": cc.cache_bytes,
        "analytic_compute_s": cc.flops / chips / PEAK_FLOPS,
        "analytic_memory_s": cc.total_bytes / chips / HBM_BW,
    }


def _attention_costs(c: CellCosts, cfg: ModelConfig, kind, b: int, s: int,
                     step: str) -> None:
    """One attention (or MLA) layer's score and cache traffic; a windowed
    layer sees ``ctx = min(window, S)`` positions."""
    if kind.mixer == "mla":
        qk_dim = cfg.num_heads * (cfg.qk_nope_head_dim
                                  + cfg.qk_rope_head_dim)
        v_dim = cfg.num_heads * cfg.v_head_dim
        kv_line = cfg.kv_lora_rank + cfg.qk_rope_head_dim   # latent
    else:
        qk_dim = v_dim = cfg.q_dim
        kv_line = 2 * cfg.kv_dim
    ctx = min(kind.window, s) if kind.window else s
    # int8 KV cache: 1 B/elem + f32 scale per (pos, head); MLA's latents
    # stay in the activations' type
    kv_byte = ((1.0 + F32 / cfg.head_dim)
               if (cfg.kv_quant == "int8" and kind.mixer != "mla")
               else ACT)
    if step == "decode":
        # read the whole cache line per step + scores
        c.cache_bytes += b * ctx * kv_line * kv_byte + b * kv_line * kv_byte
        c.flops += 2.0 * b * ctx * (qk_dim + v_dim)
        c.act_bytes += b * cfg.num_heads * ctx * F32  # probs
    else:
        # causal S×ctx scores in f32 (written+read by softmax), ×3 for the
        # backward (dS, recompute) when training
        pairs = min((s * ctx) if kind.window else (s * ctx / 2), s * s / 2)
        factor = 3.0 if step == "train" else 1.0
        c.flops += 2.0 * b * pairs * (qk_dim + v_dim) * factor
        c.act_bytes += 2.0 * b * cfg.num_heads * pairs * F32 * factor
        if step == "prefill":
            c.cache_bytes += b * ctx * kv_line * ACT  # cache write


# ---------------------------------------------------------------------------
# Disaggregated-serving split policy (serving.disagg / ROADMAP #5)
# ---------------------------------------------------------------------------
# Prefill is compute-bound (S×ctx score work per admitted token), decode is
# bandwidth-bound (whole cache line + full weight stream per emitted token).
# The policy compares each side's arithmetic intensity to the machine
# balance point and predicts the prompt length past which one prefill's
# wall time convoys a full decode step — the crossover where running the
# two phases on separate engines starts to pay for the page transfer.

def serving_cell(step: str, seq_len: int, batch: int = 1) -> ShapeCell:
    """Ad-hoc shape cell for serving-side placement decisions."""
    return ShapeCell(f"{step}_{seq_len}x{batch}", seq_len, batch, step)


def serving_intensity(cfg: ModelConfig, *, step: str, seq_len: int,
                      batch: int = 1, quant: bool = False) -> dict:
    """Roofline terms for one serving-side dispatch shape.

    ``intensity`` is FLOPs/byte; a dispatch is compute-bound when it
    exceeds the machine balance (PEAK_FLOPS / HBM_BW), else memory-bound.
    """
    cc = cell_costs(cfg, serving_cell(step, seq_len, batch), quant)
    t_c = cc.flops / PEAK_FLOPS
    t_m = cc.total_bytes / HBM_BW
    return {
        "flops": cc.flops,
        "bytes": cc.total_bytes,
        "intensity": cc.flops / max(cc.total_bytes, 1.0),
        "compute_s": t_c,
        "memory_s": t_m,
        "time_s": max(t_c, t_m),
        "bound": "compute" if t_c >= t_m else "memory",
    }


def _prefill_time_s(cfg: ModelConfig, seq_len: int, quant: bool) -> float:
    return serving_intensity(cfg, step="prefill", seq_len=seq_len,
                             quant=quant)["time_s"]


def disagg_report(cfg: ModelConfig, *, decode_batch: int = 8,
                  context: int = 4096, quant: bool = False) -> dict:
    """Roofline-derived prefill/decode disaggregation policy for one arch
    with each side on one card.

    Returns the two sides' arithmetic intensity vs the machine balance,
    whether disaggregation is predicted to pay (prefill compute-bound AND
    decode memory-bound — the phases want different hardware operating
    points), and ``crossover_prompt_tokens``: the smallest prompt whose
    single prefill costs more wall time than one full decode step over
    ``decode_batch`` slots at ``context`` — past it, a unified engine
    admitting that prompt stalls every decoding slot by more than one
    inter-token interval, which is exactly the convoy the disagg bench
    measures. ``None`` when no prompt up to ``context`` crosses (unified
    stays the right default — small deployments land here).
    """
    pre = serving_intensity(cfg, step="prefill", seq_len=context,
                            quant=quant)
    dec = serving_intensity(cfg, step="decode", seq_len=context,
                            batch=decode_batch, quant=quant)
    # bracket the crossover by doubling, then bisect to page granularity
    crossover = None
    lo, s = 1, 16
    while s <= context:
        if _prefill_time_s(cfg, s, quant) > dec["time_s"]:
            hi = s
            while hi - lo > 16:
                mid = (lo + hi) // 2
                if _prefill_time_s(cfg, mid, quant) > dec["time_s"]:
                    hi = mid
                else:
                    lo = mid
            crossover = hi
            break
        lo, s = s, s * 2
    return {
        "machine_balance": PEAK_FLOPS / HBM_BW,
        "prefill_intensity": pre["intensity"],
        "decode_intensity": dec["intensity"],
        "prefill_bound": pre["bound"],
        "decode_bound": dec["bound"],
        "prefill_time_s": pre["time_s"],
        "decode_step_time_s": dec["time_s"],
        "disaggregate": (pre["bound"] == "compute"
                         and dec["bound"] == "memory"),
        "crossover_prompt_tokens": crossover,
    }
