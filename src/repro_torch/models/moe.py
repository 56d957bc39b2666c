"""Mixture-of-Experts: top-k routing with capacity-based scatter dispatch.

The reference's single-device algorithm (GShard-style):
  1. the f32 router's logits -> softmax -> top-k (gates, expert ids) per
     token, the gates renormalized where ``norm_topk_prob``,
  2. each token's slot in its expert by k sequential cumsums over the
     one-hot assignment (tokens past an expert's `capacity` are dropped),
  3. a scatter of the tokens into an ``[E, C, D]`` capacity buffer,
  4. every expert's GLU over its C rows (float: batched products over the
     stacked ``[E, D, F]`` weights; quantized: kernels K3 and K1 over the
     expert axis, one launch each for the whole layer),
  5. a gather back per (token, k) slot, combined with the gate weights in
     the reference's order over k,
plus the shared experts (every token, a sigmoid ``shared_gate`` on
qwen2-moe) and the Switch load-balance aux loss.

A token's row never meets another token's in a sum: the router's product
keeps a row's bits independent of the row count
(`numerics.matmul_f32_rows`), each capacity slot holds one token, K1 / K3
sum a row the same way at any M, and the combine is elementwise. So a
serving row's output does not depend on how many rows share its step.

Under a mesh (`moe_apply_tp`, one controller, the reference's three
regimes): the router runs once (replicated, the first shard's copy);
packed experts run per shard as the reference's ``body_q`` — K3 on each
shard's F stripe of ``gate`` / ``up``, ``h`` gathered over F in shard
order, K1 on each shard's D stripe of ``down``, ``y`` gathered over D;
float experts as its ``body`` — ``gate`` / ``up`` on F stripes, ``down``
row-parallel on F, the partials summed in shard order and rounded once;
the shared experts through `layers.mlp_tp`. A ``data`` axis groups
the dispatch: each data replica routes its own tokens (the batch is cut
into contiguous groups, `distributed.sharding.split_batch`) at
``capacity(cfg, T / g)``, as the reference's `shard_map` body does. The
aux loss stays the reference's global one: within `route_log`, every
layer records its probabilities and top-1 ids, and `global_aux` forms
the loss over all groups' tokens.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core.packing import PackedLinear
from repro_torch.core.qlinear import (fusable_gateup, qgateup_apply,
                                      qgateup_experts_apply,
                                      qlinear_experts_apply)
from repro_torch.distributed.sharding import all_sum, concat
from repro_torch.models import layers
from repro_torch.models.layers import activation, linear
from repro_torch.numerics import einsum_f32, einsum_wide


def moe_init(gen, cfg, dtype=torch.float32, device=None):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def stacked(a, b, s):
        w = torch.randn((e, a, b), generator=gen, device=device) * s
        return {"w": w.to(dtype)}

    p = {
        "router": layers.linear_init(gen, d, e, dtype=torch.float32,
                                     device=device),
        "experts": {
            "gate": stacked(d, f, 1.0 / math.sqrt(d)),
            "up": stacked(d, f, 1.0 / math.sqrt(d)),
            "down": stacked(f, d, 1.0 / math.sqrt(f)),
        },
    }
    if cfg.num_shared_experts:
        sf = cfg.shared_d_ff
        p["shared"] = {
            "gate": layers.linear_init(gen, d, sf, dtype=dtype, device=device),
            "up": layers.linear_init(gen, d, sf, dtype=dtype, device=device),
            "down": layers.linear_init(gen, sf, d, dtype=dtype,
                                       device=device),
        }
        if cfg.shared_expert_gate:
            p["shared_gate"] = layers.linear_init(
                gen, d, 1, dtype=torch.float32, device=device)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Rows per expert: dropless (every token fits) up to 1,024 tokens, as
    serving needs; above, the GShard capacity-factor formula, rounded up
    to a multiple of 8."""
    if n_tokens <= 1024:
        return n_tokens
    c = int(math.ceil(cfg.top_k * n_tokens / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, int(math.ceil(c / 8)) * 8)


def _glu_ffn(experts, buf, act):
    """Every expert's GLU over its rows of the ``[E, C, D]`` buffer, in
    buf's dtype: batched products over float stacks (the weights rounded
    to buf's dtype, f32 sums), or K3 then K1 over packed ones."""
    g, u, d = experts["gate"], experts["up"], experts["down"]
    if isinstance(g, PackedLinear):
        if fusable_gateup(g, u, act):
            h = qgateup_experts_apply(g, u, buf)
        else:
            h = activation(act, qlinear_experts_apply(g, buf)) \
                * qlinear_experts_apply(u, buf)
        return qlinear_experts_apply(d, h)
    dt = buf.dtype
    h = einsum_f32("ecd,edf->ecf", buf, g["w"].to(dt)).to(dt)
    h = activation(act, h) * einsum_f32("ecd,edf->ecf", buf,
                                        u["w"].to(dt)).to(dt)
    return einsum_f32("ecf,efd->ecd", h, d["w"].to(dt)).to(dt)


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """int64 one-hot ``[..., E]`` by comparison (PyTorch's ``one_hot``
    checks its input's range with a device-to-host copy, which would stall
    the host once a choice a layer)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def select(probs: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k (gates [T, k], expert ids ``idx`` [T, k]) by
    falling probability, the gates renormalized where
    ``norm_topk_prob``."""
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def assign_slots(idx: torch.Tensor, e: int, cap: int):
    """Per choice j, each token's ``slots[j]`` [T] in its expert and
    ``keeps[j]`` [T] (False past the expert's capacity; the slot is then
    cap - 1 and the token adds zeros there), from k sequential cumsums
    over the one-hot assignment, the reference's order: choice j of every
    token after choice j - 1 of all of them."""
    counts = torch.zeros((e,), dtype=torch.long, device=idx.device)
    slots, keeps = [], []
    for j in range(idx.shape[1]):
        onehot = _one_hot(idx[:, j], e)                          # [T, E]
        pos_in = torch.cumsum(onehot, dim=0) - onehot
        slot = torch.gather(pos_in, 1, idx[:, j:j + 1])[:, 0] \
            + counts[idx[:, j]]
        keep = slot < cap
        slots.append(torch.where(keep, slot, cap - 1))
        keeps.append(keep)
        counts = counts + onehot.sum(0)
    return slots, keeps


def route(probs: torch.Tensor, cfg, cap: int):
    """The dispatch's integers and gates: ``(idx, gates, slots, keeps)``
    (`select`, then `assign_slots`)."""
    gates, idx = select(probs, cfg)
    return (idx, gates, *assign_slots(idx, cfg.num_experts, cap))


def dispatch(xt, idx, slots, keeps, e: int, cap: int) -> torch.Tensor:
    """Tokens ``xt`` [T, D] -> the ``[E, cap, D]`` capacity buffer: choice j
    of token t adds its row at (idx[t, j], slots[j][t]), zeros where it
    was dropped (the reference's scatter-add; a kept slot holds one
    token)."""
    buf = torch.zeros((e, cap, xt.shape[-1]), dtype=xt.dtype,
                      device=xt.device)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    for j in range(idx.shape[1]):
        buf.index_put_((idx[:, j], slots[j]),
                       torch.where(keeps[j][:, None], xt, zero),
                       accumulate=True)
    return buf


def combine(out_buf, idx, gates, slots, keeps) -> torch.Tensor:
    """Each token's expert rows gathered back and summed with its gates,
    in the buffer's dtype and the reference's order over j."""
    zero = torch.zeros((), dtype=out_buf.dtype, device=out_buf.device)
    y = torch.zeros((idx.shape[0], out_buf.shape[-1]), dtype=out_buf.dtype,
                    device=out_buf.device)
    for j in range(idx.shape[1]):
        got = out_buf[idx[:, j], slots[j]]                        # [T, D]
        y = y + torch.where(keeps[j][:, None], got, zero) \
            * gates[:, j:j + 1].to(out_buf.dtype)
    return y


_ROUTES: list | None = None


@contextlib.contextmanager
def route_log():
    """Within, every MoE layer's forward appends ``(probs [T, E], top-1
    ids [T])`` to the yielded list, in call order (a backward's
    recomputation records nothing: it runs after the block closes)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def aux_loss(probs: torch.Tensor, top1: torch.Tensor, cfg) -> torch.Tensor:
    """The Switch load-balance loss: ``w · E · Σ_e mean(probs)_e ·
    share of top-1 choices_e`` over the tokens given."""
    e = cfg.num_experts
    me = probs.mean(dim=0)
    ce = _one_hot(top1, e).to(torch.float32).mean(dim=0)
    return cfg.router_aux_weight * e * (me * ce).sum()


def global_aux(routes: list, groups: int, cfg) -> torch.Tensor:
    """The aux loss of each MoE layer over all data groups' tokens (the
    reference's, from the global probs and top-1 ids), summed over
    layers. ``routes`` is a `route_log` of ``groups`` replicas' forwards,
    each replica's layers in order; groups join in replica order on the
    first group's device."""
    per = len(routes) // groups
    total = None
    for layer in range(per):
        got = [routes[g * per + layer] for g in range(groups)]
        dev = got[0][0].device
        aux = aux_loss(torch.cat([p.to(dev) for p, _ in got]),
                       torch.cat([i.to(dev) for _, i in got]), cfg)
        total = aux if total is None else total + aux
    return total


def _route(router, xt, cfg):
    """The f32 router → (probs, cap, idx, gates, slots, keeps), the
    routing recorded when a `route_log` is open."""
    probs = torch.softmax(linear(router, xt.to(torch.float32)), dim=-1)
    cap = capacity(cfg, xt.shape[0])
    idx, gates, slots, keeps = route(probs, cfg, cap)
    if _ROUTES is not None:
        _ROUTES.append((probs, idx[:, 0]))
    return probs, cap, idx, gates, slots, keeps


def _glu_ffn_tp(experts: list, buf, act, f: int, devices: list):
    """`_glu_ffn` over the shards' expert stripes (``f``: the unsplit
    expert d_ff): packed — K3 (or the two products) on each shard's F
    stripe, ``h`` joined over F in shard order, K1 on each shard's D
    stripe, joined over D; float — ``gate`` / ``up`` on F stripes,
    ``down``'s F-row partials summed in shard order and rounded once. A
    leaf the rule leaves whole runs once, on the first shard."""
    ex0, d = experts[0], buf.shape[-1]
    if not isinstance(ex0["gate"], PackedLinear):
        if ex0["gate"]["w"].shape[-1] == f:
            return _glu_ffn(ex0, buf, act)
        dt = buf.dtype
        parts = []
        for ex, dv in zip(experts, devices):
            b = buf.to(dv)
            h = einsum_f32("ecd,edf->ecf", b, ex["gate"]["w"].to(dt)).to(dt)
            h = activation(act, h) * einsum_f32(
                "ecd,edf->ecf", b, ex["up"]["w"].to(dt)).to(dt)
            parts.append(einsum_wide("ecf,efd->ecd", h,
                                     ex["down"]["w"].to(dt)))
        return all_sum(parts, devices).to(torch.float32).to(dt)

    def gateup(ex, b):
        g, u = ex["gate"], ex["up"]
        if fusable_gateup(g, u, act):
            return qgateup_experts_apply(g, u, b)
        return activation(act, qlinear_experts_apply(g, b)) \
            * qlinear_experts_apply(u, b)
    if ex0["gate"].n < f:
        h = concat([gateup(ex, buf.to(dv))
                    for ex, dv in zip(experts, devices)], -1, devices)
    else:
        h = gateup(ex0, buf)
    if ex0["down"].n < d:
        return concat([qlinear_experts_apply(ex["down"], h.to(dv))
                       for ex, dv in zip(experts, devices)], -1, devices)
    return qlinear_experts_apply(ex0["down"], h)


def moe_apply_tp(ps: list, x: torch.Tensor, cfg, devices: list
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """`moe_apply` over a ``model`` mesh's shards (``ps``: one MoE layer's
    params a shard, ``devices`` in shard order) on one data group's
    tokens ``x`` (replicated, on the first shard's device) → (y, aux).
    Replicated leaves (the router, ``shared_gate``) are read on the first
    shard only."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    e = cfg.num_experts
    probs, cap, idx, gates, slots, keeps = _route(ps[0]["router"], xt, cfg)
    out_buf = _glu_ffn_tp([p["experts"] for p in ps],
                          dispatch(xt, idx, slots, keeps, e, cap), cfg.act,
                          cfg.moe_d_ff, devices)
    y = combine(out_buf, idx, gates, slots, keeps)
    if "shared" in ps[0]:
        s_out = layers.mlp_tp([p["shared"] for p in ps], xt, cfg.act, devices,
                              cfg.d_model, cfg.shared_d_ff)
        if "shared_gate" in ps[0]:
            sg = torch.sigmoid(linear(ps[0]["shared_gate"],
                                      xt.to(torch.float32)))
            s_out = s_out * sg.to(s_out.dtype)
        y = y + s_out
    return y.reshape(*lead, d), aux_loss(probs, idx[:, 0], cfg)


def moe_apply(p, x: torch.Tensor, cfg, name=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] (or [T, D]) -> (y, aux_loss). ``name`` (local path ->
    capture name, or None) labels the shared experts' linears for
    calibration; the routed experts and the router record nothing, as in
    the reference (routed experts quantize at RTN)."""
    nm = (lambda s: None) if name is None else name
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    e = cfg.num_experts
    probs, cap, idx, gates, slots, keeps = _route(p["router"], xt, cfg)

    out_buf = _glu_ffn(p["experts"], dispatch(xt, idx, slots, keeps, e, cap),
                       cfg.act)
    y = combine(out_buf, idx, gates, slots, keeps)

    if "shared" in p:
        sh = p["shared"]
        if fusable_gateup(sh["gate"], sh["up"], cfg.act):
            h = qgateup_apply(sh["gate"], sh["up"], xt)
        else:
            h = activation(cfg.act, linear(sh["gate"], xt,
                                           nm("shared/gate"))) \
                * linear(sh["up"], xt, nm("shared/up"))
        s_out = linear(sh["down"], h, nm("shared/down"))
        if "shared_gate" in p:
            sg = torch.sigmoid(linear(p["shared_gate"],
                                      xt.to(torch.float32)))
            s_out = s_out * sg.to(s_out.dtype)
        y = y + s_out

    return y.reshape(*lead, d), aux_loss(probs, idx[:, 0], cfg)
