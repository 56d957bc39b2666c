"""The reductions the metric readers share: from the window's host-clock
record, the scheduler's counters, the traced run's kernel calls and its
profiler trace to one number each. A reduction that finds nothing to read
returns None, and the harness leaves that metric out of the line.
"""
from __future__ import annotations

import numpy as np

from perfbench import costs, stats

K1_K3 = ("LinearOut", "GluOut")      # K1's and K3's kernels' template tags
K2 = ("paged_partial", "paged_merge")


def output_tok_s(run):
    w = run.window
    return w.tokens() / w.seconds if w.seconds > 0 else None


def tail_ms(values, q: float = 95.0):
    return 1e3 * stats.percentile(values, q) if values else None


def padding_waste_pct(run):
    """Padded share of the positions dispatched over the window."""
    a, b = run.stats_open, run.stats_close
    disp = b["dispatched_positions"] - a["dispatched_positions"]
    pad = b["padded_positions"] - a["padded_positions"]
    return 100.0 * pad / disp if disp > 0 else None


def step_ms(run, prefill_only: bool = False):
    """Mean host time of the window's steps outside the profiled span
    (with ``prefill_only``: of those that carried prompt tokens)."""
    steps = run.window.steps
    ts = [steps[i][1] - steps[i][0] for i in run.free_steps()
          if steps[i][0] >= run.window.t_open
          and (not prefill_only or steps[i][3] > 0)]
    return 1e3 * sum(ts) / len(ts) if ts else None


def mfu_pct(run):
    """Useful FLOPs of the window's steps outside the profiled span (prompt
    and decode positions through the linears, attention over each
    position's visible keys, the head at sampled rows) over those steps'
    share of the window at the card's bf16 peak."""
    pk = costs.peaks(run.device_kind)
    if pk is None or not run.steps_pos:
        return None
    w = run.window
    flops = 0.0
    for i in run.free_steps():
        s = w.steps[i]
        if s[0] < w.t_open or i not in run.steps_pos:
            continue
        pos = run.steps_pos[i]
        valid = pos >= 0
        flops += costs.step_flops(run.config, int(valid.sum()),
                                  int((pos[valid] + 1).sum()), s[2])
    a, b = run.excluded
    held = max(0.0, min(b, w.t_close) - max(a, w.t_open))
    secs = w.seconds - held
    return 100.0 * flops / (secs * pk["bf16_flops"]) if flops else None


def qlinear_roofline_pct(run):
    """Sum of K1's and K3's bounds over the profiled calls, over those
    kernels' device time in the trace."""
    pk = costs.peaks(run.device_kind)
    if pk is None or run.trace is None:
        return None
    t = run.trace.kernel_s(K1_K3)
    calls = run.calls.get("k1", []) + run.calls.get("k3", [])
    if not t or not calls:
        return None
    bound = 0.0
    for c in run.calls.get("k1", []):
        f, by = costs.awq_matmul_cost(*c)
        bound += max(f / pk["bf16_flops"], by / pk["hbm_bytes_s"])
    for c in run.calls.get("k3", []):
        f, by = costs.awq_gateup_cost(*c)
        bound += max(f / pk["bf16_flops"], by / pk["hbm_bytes_s"])
    return 100.0 * bound / t


def paged_attn_roofline_pct(run):
    """K2's bound over the profiled calls (f32 math at the card's f32
    peak; the keys each row's positions make visible), over its device
    time in the trace."""
    pk = costs.peaks(run.device_kind)
    if pk is None or run.trace is None:
        return None
    t = run.trace.kernel_s(K2)
    calls = run.calls.get("k2", [])
    if not t or not calls:
        return None
    bound = 0.0
    for (b, c, hkv, g, hd), n_blocks, pos in calls:
        valid = pos >= 0
        row_keys = np.where(valid.any(axis=1), pos.max(axis=1) + 1, 0)
        f, by = costs.paged_attention_cost(
            hkv * g, hkv, hd, c, n_blocks, [int(k) for k in row_keys],
            int((pos[valid] + 1).sum()))
        bound += max(f / pk["f32_flops"], by / pk["hbm_bytes_s"])
    return 100.0 * bound / t


def traced_prefill_share(run):
    """Share of the profiled steps that carried prompt tokens (the
    `prefill_tokens` counter moved); the rest decoded only."""
    a, b = run.excluded
    st = [s for s in run.window.steps if s[0] >= a and s[1] <= b]
    return 100.0 * sum(1 for s in st if s[3] > 0) / len(st) if st else None


def device_idle_pct(run):
    """None where the trace holds no device operation (a run without a
    card)."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
