"""Card-only tests: kernels K1, K2, K3 and K4 against their plain versions on
an NVIDIA GPU (Hopper, sm_90a). They skip where torch sees no CUDA device;
run them on the card with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_cuda.py`` (the suite's conftest
imports JAX, which this file does not need).

Tolerances: K1 sums exact bf16 × bf16 products in f32 in another order
than the plain version (rtol/atol 1e-4 of the output scale; with a bf16
output, plus one bf16 ulp of the plain value); K3 too, in
its f32 output, while its bf16 output rounds g, u, silu(g) and the
product to bf16 as the two-linear MLP does, so a sum a few f32 ulps off
may round to a neighbouring bf16 value at each of those steps (1e-5 of
the output scale plus 2^-6 of the value, four bf16 ulps); K2 runs the
same f32 math with an online softmax over split keys, merged in span
order (1e-5 of max(1, the output scale)). K4 computes in f32 with an
online softmax too (bf16 / f16 products on tensor cores, exact; f32
probabilities split into two halves of the input type for PV) and rounds
once to the input type, so two results a few f32 ulps apart may round to
neighbouring values: atol 1e-5 plus one unit of the type's precision
relative to the value (`torch.finfo(dtype).eps`).

The serving cases run the smoke model (Qwen2.5's 14 q / 2 kv heads at
d_model 128, RTN int4) through the engine on the card: a page commit
equal to the CPU's, one-shot streams equal to chunked ones over bf16
pools, greedy parallel siblings equal to each other, a spill → restore
round trip of int8 pages byte for byte through pinned host memory, a
handoff's wire image equal to a synchronous gather of the same pages,
preempted streams equal to uninterrupted ones, and speculation: the
head's rows equal across verify widths, a verify row equal to the same
row in a plain step, `_tree_compact` equal to the CPU's, and greedy
n-gram, tree and draft-model streams equal to the plain engine's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (deepseek_v2_lite, glm4_9b, hymba_15b,
                                 mamba2_130m, qwen2_moe_a27b, qwen25_05b)
from repro_torch.core.packing import pack_linear
from repro_torch.core.pipeline import quantize_params
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.core.quantize import QuantConfig, quantize_groupwise
from repro_torch.kernels import awq_matmul as k1
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import paged_attention as k2
from repro_torch.models import attention, blocks, layers, mla, moe
from repro_torch.models.model import Model
from repro_torch.serving import disagg, kv_pager
from repro_torch.serving.engine import GenerationEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("k,n", [(896, 896), (896, 128), (896, 4864),
                                 (4864, 896), (256, 136)])
@pytest.mark.parametrize("m", [1, 3, 4, 7, 16, 64])
def test_awq_matmul_kernel_matches_plain(cuda, m, k, n):
    cfg = QuantConfig(group_size=64)
    w = torch.randn(k, n, generator=cuda, device="cuda") / k ** 0.5
    p = pack_linear(*quantize_groupwise(w, cfg), None, None, cfg)
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    before = k1.COUNTER.count
    out = k1.awq_matmul(x, p.qweight, p.scales, p.zeros, 64)
    ref = k1.awq_matmul_ref(x, p.qweight, p.scales, p.zeros, 64,
                            torch.bfloat16)
    torch.cuda.synchronize()
    assert k1.COUNTER.count == before + 1
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-4 * scale


def test_awq_matmul_kernel_rejects_what_it_does_not_take(cuda):
    cfg = QuantConfig(group_size=64)
    p = pack_linear(*quantize_groupwise(
        torch.randn(128, 64, device="cuda"), cfg), None, None, cfg)
    w = (p.qweight, p.scales, p.zeros, 64)
    x = torch.randn(2, 128, device="cuda").to(torch.bfloat16)
    ones = torch.ones(129, device="cuda")
    for call in (
            lambda: k1.awq_matmul(x.half(), *w),                   # f16 x
            lambda: k1.awq_matmul(x, *w, torch.float32),           # f32 compute
            lambda: k1.awq_matmul(x, *w, out_dtype=torch.half),    # f16 out
            lambda: k1.awq_matmul(torch.randn(2, 256, device="cuda").to(
                torch.bfloat16)[:, ::2], *w),                      # strided x
            lambda: k1.awq_matmul(x, *w, input_scale=ones),        # K + 1
            lambda: k1.awq_matmul(x, *w, input_scale=ones[1:])):   # misaligned
        with pytest.raises(ValueError):
            call()


def _k1_linear(gen, k, n, gs, scaled):
    cfg = QuantConfig(group_size=gs)
    p = pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5, cfg),
        None, None, cfg)
    scale = (torch.rand(k, generator=gen, device="cuda") + 0.5
             if scaled else None)
    return (p.qweight, p.scales, p.zeros, gs), scale


def _bf16_ulp(v):
    """One bf16 unit in the last place of each |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v.float()), e - 8)


def _k1_check(out, ref):
    """f32 output: 1e-4 of the output scale (only the order of the sums
    differs); bf16 output: that plus one bf16 ulp of |plain| (the f32
    totals may round to neighbouring bf16 values)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs()
    lim = 1e-4 * float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        lim = lim + _bf16_ulp(ref)
    assert bool((err <= lim).all()), float((err - lim).max())


def _k1_run(x, w, scale, out_dtype):
    """One kernel call and its plain version; the call is one launch."""
    kw = dict(input_scale=scale, out_dtype=out_dtype)
    before = k1.COUNTER.count
    out = k1.awq_matmul(x, *w, **kw)
    torch.cuda.synchronize()
    assert k1.COUNTER.count == before + 1
    return out, k1.awq_matmul_ref(x, *w, torch.bfloat16, **kw)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain_x", "awq_x"])
@pytest.mark.parametrize("m", [1, 4, 16, 64, 1024])
@pytest.mark.parametrize("k,n", [(896, 896), (896, 128), (896, 4864),
                                 (4864, 896)])
def test_awq_matmul_kernel_input_scale_and_bf16_out(cuda, k, n, m, scaled):
    """Qwen2.5's four (K, N) pairs with the model's arguments (input
    scale, bf16 output) and the TPU function's (f32 output)."""
    w, scale = _k1_linear(cuda, k, n, 64, scaled)
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        _k1_check(*_k1_run(x, w, scale, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain_x", "awq_x"])
@pytest.mark.parametrize("k,n", [(896, 896), (4864, 896)])
def test_awq_matmul_kernel_rows_equal_across_m(cuda, k, n, scaled,
                                               out_dtype):
    """The summation rule: the rows of an M 1024 launch are bit-identical
    to the same rows at smaller M (the decode kernel at M <= 16, the
    prefill kernel above, with and without the spans split over
    blocks)."""
    w, scale = _k1_linear(cuda, k, n, 64, scaled)
    x = torch.randn(1024, k, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    kw = dict(input_scale=scale, out_dtype=out_dtype)
    full = k1.awq_matmul(x, *w, **kw)
    for m in (1, 4, 7, 8, 16, 64, 200):
        part = k1.awq_matmul(x[:m].contiguous(), *w, **kw)
        assert torch.equal(part, full[:m]), m
    tail = k1.awq_matmul(x[900:].contiguous(), *w, **kw)
    assert torch.equal(tail, full[900:])


@pytest.mark.parametrize("m", [4, 64, 1024])
def test_awq_matmul_kernel_deterministic(cuda, m):
    w, scale = _k1_linear(cuda, 4864, 896, 64, True)
    x = torch.randn(m, 4864, generator=cuda, device="cuda").to(torch.bfloat16)
    kw = dict(input_scale=scale, out_dtype=torch.bfloat16)
    assert torch.equal(k1.awq_matmul(x, *w, **kw), k1.awq_matmul(x, *w, **kw))


@pytest.mark.parametrize("scaled", [False, True], ids=["plain_x", "awq_x"])
@pytest.mark.parametrize("m", [1, 13, 80])
def test_awq_matmul_kernel_ragged_shapes(cuda, m, scaled):
    """K 200 at GS 40 (a last span of 72 k: a half-empty k16 step), N 136
    (a partial 16- and 64-column tile), f32 x; one launch per call."""
    w, scale = _k1_linear(cuda, 200, 136, 40, scaled)
    x = torch.randn(m, 200, generator=cuda, device="cuda")
    for out_dtype in (torch.float32, torch.bfloat16):
        _k1_check(*_k1_run(x, w, scale, out_dtype))


@pytest.mark.parametrize("m", [1, 64])
def test_awq_matmul_kernel_split_spans_fewest_columns(cuda, m):
    """K 4864, N 128 (the fewest columns at down's depth): the 38 spans
    split over blocks and merged in span order; the rows equal the same
    rows of an M 1024 launch."""
    w, scale = _k1_linear(cuda, 4864, 128, 64, True)
    assert k1.span_block(m, 4864, 128) < 38
    x = torch.randn(1024, 4864, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        out, ref = _k1_run(x[:m].contiguous(), w, scale, out_dtype)
        _k1_check(out, ref)
        full = k1.awq_matmul(x, *w, input_scale=scale, out_dtype=out_dtype)
        assert torch.equal(out, full[:m])


def _k3_check(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        assert float(err.max()) <= 1e-4 * scale
    else:
        lim = 1e-5 * scale + 2 ** -6 * ref.float().abs()
        assert bool((err <= lim).all()), float((err - lim).max())


@pytest.mark.parametrize("scaled", [False, True], ids=["plain_x", "awq_x"])
@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 16, 1024])
@pytest.mark.parametrize("k,n", [(896, 4864), (4864, 896)])
def test_awq_gateup_kernel_matches_plain(cuda, k, n, m, gs, scaled):
    cfg = QuantConfig(group_size=gs)
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=cuda, device="cuda") / k ** 0.5, cfg),
        None, None, cfg) for _ in range(2))
    scales = ((torch.rand(k, generator=cuda, device="cuda") + 0.5,
               torch.rand(k, generator=cuda, device="cuda") + 0.5)
              if scaled else None)
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    args = (x, g.qweight, g.scales, g.zeros, u.qweight, u.scales, u.zeros,
            gs)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(input_scales=scales, out_dtype=out_dtype)
        before = k1.GATEUP_COUNTER.count
        out = k1.awq_gateup(*args, **kw)
        ref = k1.awq_gateup_ref(*args, torch.bfloat16, **kw)
        torch.cuda.synchronize()
        assert k1.GATEUP_COUNTER.count == before + 1
        _k3_check(out, ref)


def test_awq_gateup_kernel_f32_x_and_rows_independent_of_m(cuda):
    """f32 activations are scaled and rounded in the kernel; a row's
    result does not depend on how many rows share the launch."""
    cfg = QuantConfig(group_size=64)
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(896, 256, generator=cuda, device="cuda") / 30, cfg),
        None, None, cfg) for _ in range(2))
    x = torch.randn(13, 896, generator=cuda, device="cuda")
    s = (torch.rand(896, generator=cuda, device="cuda") + 0.5,
         torch.rand(896, generator=cuda, device="cuda") + 0.5)
    args = (g.qweight, g.scales, g.zeros, u.qweight, u.scales, u.zeros, 64)
    out = k1.awq_gateup(x, *args, input_scales=s)
    _k3_check(out, k1.awq_gateup_ref(x, *args, torch.bfloat16,
                                     input_scales=s))
    for m in (1, 3, 8):
        part = k1.awq_gateup(x[:m].contiguous(), *args, input_scales=s)
        assert torch.equal(part, out[:m])


def _k3_pair(gen, k, n, gs, scaled):
    cfg = QuantConfig(group_size=gs)
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5, cfg),
        None, None, cfg) for _ in range(2))
    scales = ((torch.rand(k, generator=gen, device="cuda") + 0.5,
               torch.rand(k, generator=gen, device="cuda") + 0.5)
              if scaled else None)
    return (g.qweight, g.scales, g.zeros, u.qweight, u.scales, u.zeros,
            gs), scales


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain_x", "awq_x"])
def test_awq_gateup_kernel_rows_equal_across_m(cuda, scaled, out_dtype):
    """The summation rule: the rows of an M 1024 launch (the prefill
    kernel) are bit-identical to the same rows at smaller M (the decode
    kernel at M <= 16, the prefill kernel above)."""
    args, scales = _k3_pair(cuda, 896, 4864, 64, scaled)
    x = torch.randn(1024, 896, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    kw = dict(input_scales=scales, out_dtype=out_dtype)
    full = k1.awq_gateup(x, *args, **kw)
    for m in (1, 4, 7, 8, 16, 64, 200):
        part = k1.awq_gateup(x[:m].contiguous(), *args, **kw)
        assert torch.equal(part, full[:m]), m
    # rows past the first tile of 64, launched on their own
    tail = k1.awq_gateup(x[900:].contiguous(), *args, **kw)
    assert torch.equal(tail, full[900:])


@pytest.mark.parametrize("m", [4, 64, 1024])
def test_awq_gateup_kernel_deterministic(cuda, m):
    args, scales = _k3_pair(cuda, 896, 4864, 64, True)
    x = torch.randn(m, 896, generator=cuda, device="cuda").to(torch.bfloat16)
    kw = dict(input_scales=scales, out_dtype=torch.bfloat16)
    assert torch.equal(k1.awq_gateup(x, *args, **kw),
                       k1.awq_gateup(x, *args, **kw))


@pytest.mark.parametrize("scaled", [False, True], ids=["plain_x", "awq_x"])
@pytest.mark.parametrize("m", [1, 13, 80])
def test_awq_gateup_kernel_ragged_shapes(cuda, m, scaled):
    """K 200 at GS 40 (a last span of 72 k: a half-empty k16 step), N 136
    (a partial 16- and 64-column tile), f32 x; one launch per call."""
    args, scales = _k3_pair(cuda, 200, 136, 40, scaled)
    x = torch.randn(m, 200, generator=cuda, device="cuda")
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(input_scales=scales, out_dtype=out_dtype)
        before = k1.GATEUP_COUNTER.count
        out = k1.awq_gateup(x, *args, **kw)
        torch.cuda.synchronize()
        assert k1.GATEUP_COUNTER.count == before + 1
        _k3_check(out, k1.awq_gateup_ref(x, *args, torch.bfloat16, **kw))


def test_awq_gateup_kernel_rejects_what_it_does_not_take(cuda):
    cfg = QuantConfig(group_size=64)
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(128, n, device="cuda"), cfg), None, None, cfg)
        for n in (64, 72))
    x = torch.randn(2, 128, device="cuda").to(torch.bfloat16)
    ok = (g.qweight, g.scales, g.zeros, g.qweight, g.scales, g.zeros, 64)
    bad_n = (g.qweight, g.scales, g.zeros, u.qweight, u.scales, u.zeros, 64)
    ones = torch.ones(129, device="cuda")
    for call in (
            lambda: k1.awq_gateup(x.half(), *ok),                  # f16 x
            lambda: k1.awq_gateup(x, *ok, torch.float32),          # f32 compute
            lambda: k1.awq_gateup(x, *ok, out_dtype=torch.half),   # f16 out
            lambda: k1.awq_gateup(torch.randn(2, 256, device="cuda").to(
                torch.bfloat16)[:, ::2], *ok),                     # strided x
            lambda: k1.awq_gateup(x, *bad_n),                      # N differs
            lambda: k1.awq_gateup(x, *ok, input_scales=(ones[:128],)),
            lambda: k1.awq_gateup(x, *ok, input_scales=(
                ones[1:], ones[1:]))):                             # misaligned
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("c", [1, 5, 16, 32])
def test_paged_attention_kernel_matches_plain(cuda, c):
    b, hkv, g, hd, page, nblk = 4, 2, 7, 64, 16, 32
    npages = b * nblk + 1
    kp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=cuda,
                       device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=cuda,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(npages, page, hkv, generator=cuda, device="cuda") / 50
    vs = torch.rand(npages, page, hkv, generator=cuda, device="cuda") / 50
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")[
        :b * nblk] + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 37, 300, nblk * page - c], dtype=torch.int32,
                        device="cuda")
    pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                       device="cuda")[None]
    pos[2, c // 2 + 1:] = -1
    pos[0] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    amask = k2.default_amask(pos)
    amask[1, -1, :] = False
    for kw in ({}, dict(amask=amask, rpos=pos.clone(), window=40)):
        before = k2.COUNTER.count
        out = k2.paged_attention_chunk(q, kp, ks, vp, vs, table, pos, **kw)
        ref = k2.paged_attention_chunk_ref(q, kp, ks, vp, vs, table, pos,
                                           **kw)
        torch.cuda.synchronize()
        assert k2.COUNTER.count == before + 1
        assert float((out - ref).abs().max()) <= 1e-5
        assert not out[0].any()                 # all-padding row: exact 0


@pytest.mark.parametrize("window", [0, 128])
def test_paged_attention_kernel_tree_rows(cuda, window):
    """A token-tree verify row, as tree speculation lays it out: logical
    positions ``rpos`` = base + depth, the ancestor closure as ``amask``;
    one node with an empty ancestor row and no committed keys gives 0."""
    parents = [-1, 0, 1, 2, 0, 4, 1, 6]
    c, b, hkv, g, hd, page, nblk = len(parents), 3, 2, 7, 64, 16, 32
    anc = torch.zeros(c, c, dtype=torch.bool)
    depth = [0] * c
    for j, par in enumerate(parents):
        if par >= 0:
            anc[j], depth[j] = anc[par], depth[par] + 1
        anc[j, j] = True
    npages = b * nblk + 1
    kp, vp = (torch.randint(-127, 128, (npages, page, hkv, hd),
                            generator=cuda, device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(npages, page, hkv, generator=cuda, device="cuda")
              / 50 for _ in range(2))
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 137, 300], dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    rpos = (base[:, None] + torch.tensor(depth, dtype=torch.int32,
                                         device="cuda")[None]).contiguous()
    amask = anc[None].repeat(b, 1, 1).cuda()
    amask[0, 5] = False
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    kw = dict(rpos=rpos, amask=amask, window=window)
    out = k2.paged_attention_chunk(q, kp, ks, vp, vs, table, pos, **kw)
    ref = k2.paged_attention_chunk_ref(q, kp, ks, vp, vs, table, pos, **kw)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    assert not out[0, 5].any()
    assert out[1].abs().sum() > 0


def _k2_pools(gen, npages, page, hkv, hd):
    kp, vp = (torch.randint(-127, 128, (npages, page, hkv, hd),
                            generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand(npages, page, hkv, generator=gen, device="cuda")
              / 50 for _ in range(2))
    return kp, ks, vp, vs


def _k2_run(q, pools, table, pos, **kw):
    """Kernel and plain version on the same inputs; the kernel within
    1e-5 x max(1, max|plain|), rows that see nothing exactly 0."""
    kp, ks, vp, vs = pools
    out = k2.paged_attention_chunk(q, kp, ks, vp, vs, table, pos, **kw)
    ref = k2.paged_attention_chunk_ref(q, kp, ks, vp, vs, table, pos, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol
    vis = k2.chunk_visibility_ref(pos, s_slot=table.shape[1] * kp.shape[1],
                                  rpos=kw.get("rpos"), amask=kw.get("amask"),
                                  window=kw.get("window", 0))
    assert not out[~vis.any(dim=-1)].any()
    return out


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("n_keys", [1, 127, 128, 129, 511, 512])
def test_paged_attention_kernel_span_edges(cuda, n_keys, c):
    """Slots whose keys end at and around a 128-key span boundary
    (pos[b, 0] + C = n_keys where C allows), beside a padding slot."""
    b, hkv, g, hd, page, nblk = 3, 2, 7, 64, 16, 32
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([max(0, n_keys - c), max(0, n_keys - c - 1), -1],
                        dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[2] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    out = _k2_run(q, pools, table, pos)
    assert not out[2].any()


@pytest.mark.parametrize("c", [1, 16])
def test_paged_attention_kernel_long_slot(cuda, c):
    """A 4,096-token slot of 256 pages (32 spans) beside a short one."""
    b, hkv, g, hd, page, nblk = 2, 2, 7, 64, 16, 256
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([4096 - c, 100], dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    _k2_run(q, pools, table, pos)
    _k2_run(q, pools, table, pos, window=128)


@pytest.mark.parametrize("hd,c,g", [(64, 59, 7), (128, 27, 7), (128, 11, 3),
                                    (64, 3, 1)])
def test_paged_attention_kernel_row_counts(cuda, hd, c, g):
    """C·G not a multiple of the 32-row group, up to the most rows the
    single-block design took (413 at hd 64, 189 at hd 128), and hd 128."""
    b, hkv, page, nblk = 2, 2, 16, 24
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([nblk * page - c, 40], dtype=torch.int32,
                        device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[1, c // 2:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    _k2_run(q, pools, table, pos)


@pytest.mark.parametrize("window", [0, 5])
def test_paged_attention_kernel_default_mask_in_kernel(cuda, window):
    """No amask: the kernel applies `default_amask`'s rule itself, bit for
    bit what it computes from the explicit mask."""
    b, c, hkv, g, hd, page, nblk = 3, 16, 2, 7, 64, 16, 32
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 250, 490], dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[1, 9:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    implicit = _k2_run(q, pools, table, pos, window=window)
    explicit = _k2_run(q, pools, table, pos, window=window,
                       amask=k2.default_amask(pos, window).contiguous())
    assert torch.equal(implicit, explicit)


def test_paged_attention_kernel_deterministic_and_slot_independent(cuda):
    """Two runs give the same bits, and a slot's output does not change
    when another slot's context grows (its split points are its own)."""
    b, c, hkv, g, hd, page, nblk = 3, 16, 2, 7, 64, 16, 32
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    outs = []
    for grown in (30, 30, 480):
        base = torch.tensor([200, grown, 0], dtype=torch.int32,
                            device="cuda")
        pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                            device="cuda")[None]).contiguous()
        outs.append(_k2_run(q, pools, table, pos))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][0], outs[2][0])
    assert torch.equal(outs[0][2], outs[2][2])
    assert not torch.equal(outs[0][1], outs[2][1])


def _k4_check(out, ref, dtype):
    assert out.dtype == ref.dtype == dtype
    err = (out.float() - ref.float()).abs()
    lim = 1e-5 + torch.finfo(dtype).eps * ref.float().abs()
    assert bool((err <= lim).all()), float((err - lim).max())


def _k4_inputs(gen, b, h, hkv, s, hd, dtype):
    q = torch.randn(b, h, s, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, hkv, s, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, hkv, s, hd, generator=gen, device="cuda").to(dtype)
    return q, k, v


# b, h, hkv, s, causal, window: the shapes of chip_smoke.py's kernels line
# (Qwen2.5: 14 q heads over 2 kv heads), then GQA g = 1, 2, 7
K4_CASES = [
    (2, 14, 2, 64, True, 0),        # calibration forward
    (4, 14, 2, 256, True, 0),       # launcher prefill
    (1, 14, 2, 1000, True, 0),      # ragged tail (not a tile multiple)
    (1, 14, 2, 1000, True, 128),    # sliding window
    (1, 14, 2, 300, False, 0),      # bidirectional
    (2, 4, 4, 77, True, 0),         # g = 1
    (1, 4, 2, 129, True, 33),       # g = 2, window
    (1, 7, 1, 40, False, 16),       # g = 7, window without causality
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,hkv,s,causal,window", K4_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, h, hkv, s, causal,
                                              window, dtype):
    q, k, v = _k4_inputs(cuda, b, h, hkv, s, 64, dtype)
    before = k4.COUNTER.count
    out = k4.flash_attention(q, k, v, causal=causal, window=window)
    ref = k4.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k4.COUNTER.count == before + 1
    _k4_check(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_flash_attention_kernel_hd128_and_strided_views(cuda, dtype):
    """hd 128, and inputs passed as ``transpose(1, 2)`` views of
    [B, S, H, hd] projections (the layout `attention()` hands over): the
    output takes q's layout."""
    b, s, h, hkv, hd = 2, 50, 6, 3, 128
    qs = torch.randn(b, s, h, hd, generator=cuda, device="cuda").to(dtype)
    ks = torch.randn(b, s, hkv, hd, generator=cuda, device="cuda").to(dtype)
    vs = torch.randn(b, s, hkv, hd, generator=cuda, device="cuda").to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (qs, ks, vs))
    out = k4.flash_attention(q, k, v, scale=0.1)
    ref = k4.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale=0.1)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    _k4_check(out, ref, dtype)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _k4_inputs(cuda, 1, 4, 2, 16, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        k4.flash_attention(q, k.float(), v)                  # mixed types
    with pytest.raises(ValueError):
        k4.flash_attention(q[..., :48], k[..., :48], v[..., :48])  # hd 48
    with pytest.raises(ValueError):
        k4.flash_attention(q[:, :3], k, v)                   # H % Hkv


K4_MASKS = [(True, 0), (True, 128), (False, 0)]   # causal, window, bidir


@pytest.mark.parametrize("hd", [64, 128, 80, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("s", [1, 15, 63, 64, 65, 1000])
def test_flash_attention_kernel_edges(cuda, s, dtype, hd):
    """S around the 64-row / 64-key tiles and a long ragged one, each
    type and head dim (80 and 96: a row's 10 and 12 16-byte chunks do
    not divide the copy's 128 threads; 80: the f32 body's lanes keep 2.5
    dims each), Qwen2.5's 14 q / 2 kv heads, every mask."""
    q, k, v = _k4_inputs(cuda, 1, 14, 2, s, hd, dtype)
    for causal, window in K4_MASKS:
        out = k4.flash_attention(q, k, v, causal=causal, window=window)
        ref = k4.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        _k4_check(out, ref, dtype)


@pytest.mark.parametrize("causal,window", K4_MASKS)
@pytest.mark.parametrize("g", [1, 2, 7])
def test_flash_attention_kernel_groups_on_strided_views(cuda, g, causal,
                                                        window):
    """G = H / Hkv of 1, 2 and 7 on ``transpose(1, 2)`` views of
    [B, S, H, hd] projections, bf16 and f16."""
    b, s, hkv, hd = 2, 300, 2, 64
    h = g * hkv
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v = (torch.randn(b, s, n, hd, generator=cuda, device="cuda")
                   .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
        out = k4.flash_attention(q, k, v, causal=causal, window=window)
        ref = k4.flash_attention_ref(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal,
                                     window=window)
        torch.cuda.synchronize()
        assert out.stride() == q.stride()
        _k4_check(out, ref, dtype)


def test_flash_attention_kernel_deterministic(cuda):
    q, k, v = _k4_inputs(cuda, 2, 14, 2, 1000, 64, torch.bfloat16)
    runs = [k4.flash_attention(q, k, v) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    _k4_check(runs[0], k4.flash_attention_ref(q, k, v), torch.bfloat16)


def test_flash_attention_kernel_rejects_misaligned_rows(cuda):
    """The tensor-core body copies 16-byte rows: a bf16 view whose rows
    start off a 16-byte boundary is refused, not read wrongly."""
    q, k, v = _k4_inputs(cuda, 1, 4, 2, 16, 64, torch.bfloat16)
    flat = torch.randn(q.numel() + 1, device="cuda").to(torch.bfloat16)
    q_off = flat[1:].view(q.shape)
    with pytest.raises(ValueError):
        k4.flash_attention(q_off, k, v)
    # the f32 body reads element by element: any alignment is taken
    q32 = torch.randn(q.numel() + 1, device="cuda")[1:].view(q.shape)
    out = k4.flash_attention(q32, k.float(), v.float())
    torch.cuda.synchronize()
    _k4_check(out, k4.flash_attention_ref(q32, k.float(), v.float()),
              torch.float32)


# ------------------------------------------------------------- serving

@pytest.fixture
def smoke_engine(cuda):
    """(model, RTN int4 params on the card, a maker of engines on them)."""
    cfg = dataclasses.replace(qwen25_05b.smoke_config(), num_heads=14,
                              num_kv_heads=2)
    m = Model(cfg)
    params, _ = quantize_params(m.init(cuda, device="cuda"))

    def make(**kw):
        kw = {"max_seq": 64, "num_slots": 4, "page_size": 8, **kw}
        return GenerationEngine(m, params, **kw)
    return m, make


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_commit_prefill_on_card_equals_cpu(cuda, kv_quant):
    """The same dense prefill cache committed on the card and on the CPU:
    int8 codes and bf16 pages equal, scale strips within rtol 2e-5."""
    cfg = dataclasses.replace(qwen25_05b.smoke_config(), num_heads=14,
                              num_kv_heads=2)
    m = Model(cfg)
    pre = m.init_cache(1, 21, device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in pre["seg_0"]:
        for t in layer["kv"].values():
            t.copy_(torch.randn(t.shape, generator=g) * 3)
    out = {}
    for dev in ("cpu", "cuda"):
        pool = m.init_paged_cache(9, 8, kv_quant=kv_quant, device=dev)
        dense = {"seg_0": [{"kv": {k: t.to(dev) for k, t in e["kv"].items()}}
                           for e in pre["seg_0"]]}
        out[dev] = kv_pager.commit_prefill(pool, dense, 0, [4, 7, 2],
                                           page_size=8, start_page=1)
    for a, b in zip(out["cpu"]["seg_0"], out["cuda"]["seg_0"]):
        for key in a["kv_pool"]:
            got, ref = b["kv_pool"][key].cpu(), a["kv_pool"][key]
            if key in ("ks", "vs"):
                torch.testing.assert_close(got, ref, rtol=2e-5, atol=0)
            else:
                assert torch.equal(got, ref), key
        assert a["kv_pool"]["k"][4].abs().sum() == 0     # aliased: skipped
        assert a["kv_pool"]["k"][2].float().abs().sum() > 0


def test_oneshot_streams_equal_chunked_on_card(smoke_engine):
    """bf16 pools: the one-shot path (K4 prefill, commit, paged decode)
    and the chunked path emit the same greedy streams."""
    m, make = smoke_engine
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 9, 17, 7, 21)]
    streams = {}
    for name, kw in (("chunked", dict(prefill_chunk=8)),
                     ("one_shot", dict(chunked_prefill=False))):
        eng = make(**kw)
        before = k4.COUNTER.count
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.drain()
        assert eng._scheduler.pager.pages_in_use == 0
        streams[name] = [out[r].tolist() for r in rids]
        launched = k4.COUNTER.count - before
        assert launched == (m.cfg.num_layers * len(prompts)
                            if name == "one_shot" else 0)
    assert streams["chunked"] == streams["one_shot"]


@pytest.mark.parametrize("chunked", [True, False])
def test_parallel_siblings_identical_on_card(smoke_engine, chunked):
    """Greedy n = 3 siblings over int8 pages. Every quantized linear runs
    K1 / K3 (``offload_min_flops=0``), whose rows do not depend on their
    neighbours: on the chunked path the first sibling decodes a token in
    the followers' prefill step, at another M than theirs, which the
    default hybrid threshold would send down another path."""
    m, make = smoke_engine
    eng = make(kv_quant="int8", chunked_prefill=chunked)
    prompt = np.arange(20, dtype=np.int32) * 7 % m.cfg.vocab_size
    with execution_config(ExecutionConfig(offload_min_flops=0)):
        rids = eng.submit(prompt, 8, n=3)
        out = eng.drain()
    assert out[rids[0]].shape == (8,)
    assert all(np.array_equal(out[r], out[rids[0]]) for r in rids)
    assert eng.stats().prefix_shared_pages == 4
    assert eng._scheduler.pager.pages_in_use == 0


def _pages_bytes(eng, ids) -> dict:
    """{leaf: [L, n, ...] bytes on the host} of pages ``ids``, gathered
    synchronously (no host tier involved)."""
    layers = eng._paged_cache["seg_0"]
    return {k: torch.stack([e["kv_pool"][k][ids] for e in layers]).cpu()
            .view(torch.uint8) for k in layers[0]["kv_pool"]}


def test_spill_restore_round_trip_on_card(smoke_engine):
    """int8 pages spilled to the host tier: the parked strips lie in
    pinned host memory and hold the pages' codes and scale strips byte
    for byte; after other requests overwrite the freed pages, a restore
    puts exactly those bytes into the fresh pages."""
    m, make = smoke_engine
    eng = make(kv_quant="int8", preemption=True, num_slots=2, num_pages=9)
    rid = eng.submit(np.arange(21, dtype=np.int32) * 5 % m.cfg.vocab_size,
                     12)
    for _ in range(4):
        eng.step()
    sched = eng._scheduler
    (slot,) = sched.slots
    ids = sched.pager.peek_spill(slot)
    before = _pages_bytes(eng, ids)
    assert eng.preempt(rid)
    (parked,) = sched.preempted
    for k, t in parked.handle["strips"]["seg_0"].items():
        assert t.device.type == "cpu" and t.is_pinned(), k
    parked.handle["event"].synchronize()
    for k, t in parked.handle["strips"]["seg_0"].items():
        assert torch.equal(t.view(torch.uint8), before[k]), k
    # a higher class draws the freed pages and writes into them; the
    # parked request comes back afterwards
    other = eng.submit(np.arange(40, dtype=np.int32) % m.cfg.vocab_size, 2,
                       priority=1)
    out = eng.drain()
    st = eng.stats()
    assert st.restores == st.preemptions >= 1
    assert st.pages_spilled_now == 0 and st.pager.pages_used == 0
    assert out[rid].shape == (12,) and out[other].shape == (2,)


def test_restore_bytes_on_card(smoke_engine):
    """The restore scatter itself: the fresh pages equal the spilled
    pages byte for byte (int8 codes and scale strips)."""
    m, make = smoke_engine
    eng = make(kv_quant="int8", preemption=True, num_slots=2)
    rid = eng.submit(np.arange(21, dtype=np.int32) * 3 % m.cfg.vocab_size,
                     8)
    for _ in range(3):
        eng.step()
    sched = eng._scheduler
    (slot,) = sched.slots
    before = _pages_bytes(eng, sched.pager.peek_spill(slot))
    assert eng.preempt(rid)
    (parked,) = sched.preempted
    assert sched._try_restore(parked)
    (slot2,) = sched.slots
    after = _pages_bytes(eng, sched.pager.slot_pages[slot2])
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert eng.drain()[rid].shape == (8,)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_handoff_wire_equals_synchronous_gather_on_card(smoke_engine,
                                                        kv_quant):
    """A handoff's wire image (gathered on the card, copied to pinned
    host memory without blocking, waited on in `wire`) equals a
    synchronous gather of the same pages taken before the export, even
    when later prefill steps reuse those pages before the wire: int8
    codes and scale strips, and bf16 pages (as int16 words)."""
    m, make = smoke_engine
    pe = disagg.PrefillEngine(m, make().params, max_seq=64, num_slots=2,
                              page_size=8, kv_quant=kv_quant)
    pe.submit(np.arange(29, dtype=np.int32) * 7 % m.cfg.vocab_size, 6)
    sched = pe.engine._scheduler
    while not sched.ready_handoffs:
        pe.step()
    ids = list(sched.pager.slot_pages[sched.ready_handoffs[0][1]])
    want = _pages_bytes(pe.engine, ids)
    (h,) = pe.collect_handoffs()
    pe.submit(np.arange(40, dtype=np.int32) % m.cfg.vocab_size, 4)
    for _ in range(3):
        pe.step()                          # overwrites the freed pages
    pe.wire(h)
    assert h.wire_bytes == sum(v.numel() for v in want.values())
    for k, a in h.strips["seg_0"].items():
        got = torch.from_numpy(np.ascontiguousarray(a)).view(torch.uint8)
        assert torch.equal(got, want[k]), k


@pytest.mark.parametrize("admission", ["reserved", "optimistic"])
def test_preempted_streams_equal_uninterrupted_on_card(smoke_engine,
                                                       admission):
    """Organic SLO preemption (and, optimistic, pressure relief) over
    int8 pages on the card: with every quantized linear on K1 / K3
    (``offload_min_flops=0``, rows independent of their neighbours),
    every stream equals the same request served alone without
    preemption."""
    m, make = smoke_engine
    rng = np.random.default_rng(0)
    longs = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
             for n in (21, 25)]
    shorts = [rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)
              for n in (6, 4)]
    kw = dict(kv_quant="int8", num_slots=2, max_seq=128, prefill_chunk=8)
    with execution_config(ExecutionConfig(offload_min_flops=0)):
        eng = make(num_pages=14, preemption=True, admission=admission, **kw)
        lo = [eng.submit(p, 24) for p in longs]
        for _ in range(4):
            eng.step()
        hi = [eng.submit(p, 8, priority=1) for p in shorts]
        out = eng.drain()
        solo = make(num_pages=64, **kw)
        want = []
        for p, n in [(p, 24) for p in longs] + [(p, 8) for p in shorts]:
            r = solo.submit(p, n)
            want.append(solo.drain()[r].tolist())
    st = eng.stats()
    assert st.preemptions >= 1 and st.restores == st.preemptions
    assert st.spilled_pages == st.restored_pages > 0
    assert st.pages_spilled_now == 0 and st.pager.pages_used == 0
    assert [out[r].tolist() for r in lo + hi] == want


def test_rmsnorm_rows_equal_across_row_counts(cuda):
    """A row's RMSNorm bits do not depend on how many rows share the call
    (a chunk step's width): the rows of a 64-row call equal the same rows
    normalized 1, 4, 8 or 16 at a time, and as [4, C, D] blocks; also at
    widths that are not 28 × 32."""
    x = (torch.randn(64, 896, generator=cuda, device="cuda") * 3
         ).to(torch.bfloat16)
    p = {"gamma": torch.rand(896, generator=cuda, device="cuda") + 0.5}
    full = layers.rmsnorm(p, x)
    for n in (1, 4, 8, 16):
        for i in range(0, 64, n):
            assert torch.equal(layers.rmsnorm(p, x[i:i + n]),
                               full[i:i + n]), (n, i)
    for c in (1, 2, 16):
        blk = x[:4 * c].reshape(4, c, 896)
        assert torch.equal(layers.rmsnorm(p, blk).reshape(-1, 896),
                           full[:4 * c]), c
    ref = layers.rmsnorm({"gamma": p["gamma"].cpu()}, x.cpu())
    torch.testing.assert_close(full.cpu().float(), ref.float(), rtol=8e-3,
                               atol=0)
    # widths that split into 32s over more than two stages, or not at all
    for d in (100, 1056, 4864):
        x = torch.randn(64, d, generator=cuda, device="cuda") * 3
        p = {"gamma": torch.rand(d, generator=cuda, device="cuda") + 0.5}
        full = layers.rmsnorm(p, x)
        for n in (1, 16):
            for i in range(0, 64, n):
                assert torch.equal(layers.rmsnorm(p, x[i:i + n]),
                                   full[i:i + n]), (d, n, i)
        ref = layers.rmsnorm({"gamma": p["gamma"].cpu()}, x.cpu())
        torch.testing.assert_close(full.cpu(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- speculation

def test_head_rows_equal_across_verify_widths(cuda):
    """The tied f32 head at Qwen2.5-0.5B's width (896 → 151,936): a row's
    logits are the same bits whether the call holds 1 row (`generate`),
    4 (a decode step of 4 slots), 5, 16, 20 (a verify step of 4 rows ×
    ``spec_k + 1``) or 40, so greedy verify rows cannot part from plain
    decode at a near-tied argmax; and they equal the CPU's f64-summed
    product within f32 rounding."""
    from repro_torch.configs import get_config
    model = Model(get_config("qwen25-05b"))
    params = {"embed": {"table": (torch.randn(
        151936, 896, generator=cuda, device="cuda") * 0.02).to(
            torch.bfloat16)}}
    x = torch.randn(40, 896, generator=cuda, device="cuda").to(
        torch.bfloat16)
    full = model._head_logits(params, x)
    for m in (1, 4, 5, 16, 20):
        for i in range(0, 40 - m + 1, m):
            assert torch.equal(model._head_logits(params, x[i:i + m]),
                               full[i:i + m]), (m, i)
    assert torch.equal(model._head_logits(params, x.reshape(4, 10, 896)),
                       full.reshape(4, 10, -1))
    ref = model._head_logits({"embed": {"table": params["embed"][
        "table"].cpu()}}, x[:4].cpu())
    torch.testing.assert_close(full[:4].cpu(), ref, rtol=1e-5, atol=1e-5)


def test_verify_rows_equal_plain_step_on_card(smoke_engine):
    """One decode row's logits in a plain chunk step (``num_logits`` 1)
    and in a verify step gathering ``spec_k + 1`` logits a row, beside
    rows carrying drafts, are the same bits (int8 pools: K2; every
    quantized linear on K1 / K3)."""
    m, make = smoke_engine
    eng = make(kv_quant="int8")
    eng.submit(np.arange(12, dtype=np.int32), 4)
    eng.step()                                  # prefill: 12 tokens in
    table = eng._device_tables(eng._context_bucket(20))
    pt = table[torch.zeros(4, dtype=torch.long, device="cuda")]
    out = {}
    with execution_config(ExecutionConfig(offload_min_flops=0)):
        for r in (1, 5):
            cache = {seg: [{"kv_pool": {k: t.clone() for k, t in
                                        e["kv_pool"].items()}}
                           for e in layers]
                     for seg, layers in eng._paged_cache.items()}
            toks = torch.zeros((4, 5), dtype=torch.int32, device="cuda")
            pos = torch.full((4, 5), -1, dtype=torch.int32, device="cuda")
            toks[:, :5] = torch.arange(5, device="cuda") + 40
            pos[0, 0] = 12                      # the decode row
            pos[1, :5] = torch.arange(12, 17)   # a run with 4 drafts
            logits, _ = m.chunk_step(eng.params, cache, toks, pos,
                                     torch.zeros(4, dtype=torch.int32,
                                                 device="cuda"),
                                     page_table=pt, num_logits=r)
            out[r] = logits if r == 1 else logits[:, 0]
    assert torch.equal(out[1][0], out[5][0])


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_tree_compact_on_card_equals_cpu(smoke_engine, kv_quant):
    """`_tree_compact`'s gather-then-scatter on the card moves the same
    strips as on the CPU: int8 codes, scale strips and bf16 words equal
    on every page but the scratch page 0."""
    m, make = smoke_engine
    eng = make(kv_quant=kv_quant, page_size=4, spec_decode="ngram",
               spec_tree=True)
    eng.submit(np.arange(4, dtype=np.int32), 2)    # allocates the pools
    g = torch.Generator().manual_seed(3)
    for layers in eng._paged_cache.values():
        for e in layers:
            for k, t in e["kv_pool"].items():
                src = (torch.randint(-127, 128, t.shape, generator=g)
                       if t.dtype == torch.int8
                       else torch.randn(t.shape, generator=g))
                t.copy_(src.to(t.dtype))
    cpu = {seg: [{"kv_pool": {k: t.cpu() for k, t in e["kv_pool"].items()}}
                 for e in layers] for seg, layers in eng._paged_cache.items()}
    args = [torch.tensor(a, dtype=torch.int32) for a in (
        [[3, 5, 7, 0], [1, 2, 4, 6], [8, 9, 10, 11], [0, 0, 0, 0]],
        [2, 5, 9, -1], [[3, 4, 0], [1, 3, 5], [2, 1, 4], [1, 2, 3]],
        [2, 3, 1, 3])]
    moved = eng._tree_compact(*(a.cuda() for a in args))
    card = eng._paged_cache
    eng._paged_cache = cpu
    assert torch.equal(eng._tree_compact(*args), moved.cpu())
    for seg, layers in cpu.items():
        for a, b in zip(layers, card[seg]):
            for k in a["kv_pool"]:
                assert torch.equal(a["kv_pool"][k][1:],
                                   b["kv_pool"][k][1:].cpu()), k
    assert int(moved.sum()) == 5


@pytest.mark.parametrize("kw", [
    dict(spec_decode="ngram", spec_k=4, spec_adaptive=True),
    dict(spec_decode="ngram", spec_k=4, spec_tree=True),
    dict(spec_decode="draft_model", spec_k=4)],
    ids=["ngram", "tree", "draft_model"])
def test_spec_streams_equal_plain_on_card(smoke_engine, kw):
    """Greedy speculative streams over int8 pools equal the engine's
    without speculation, every quantized linear on K1 / K3; tree verify
    steps launch K2 with their ancestor masks, and the draft model's
    prefill launches K4."""
    m, make = smoke_engine
    rng = np.random.default_rng(4)
    prompts = [np.resize(rng.integers(0, m.cfg.vocab_size, 5), n).astype(
        np.int32) for n in (12, 20, 7, 16)]
    prompts += [rng.integers(0, m.cfg.vocab_size, 9).astype(np.int32)]
    if kw["spec_decode"] == "draft_model":
        kw = dict(kw, draft_model=m, draft_params=make().params)
    streams, tree_k2 = {}, []
    with execution_config(ExecutionConfig(offload_min_flops=0)):
        for name, extra in (("plain", {}), ("spec", kw)):
            eng = make(kv_quant="int8", **extra)
            rids = [eng.submit(p, 16) for p in prompts]
            run = eng._scheduler._run_batch

            def counted(*a, run=run, **k):
                before = k2.COUNTER.count
                res = run(*a, **k)
                if k.get("tree") is not None:
                    tree_k2.append(k2.COUNTER.count - before)
                return res
            eng._scheduler._run_batch = counted
            k4_before = k4.COUNTER.count
            out = eng.drain()
            streams[name] = [out[r].tolist() for r in rids]
            assert eng._scheduler.pager.pages_in_use == 0
    st = eng.stats()
    assert streams["spec"] == streams["plain"]
    assert st.draft_tokens > 0
    if kw.get("spec_tree"):
        assert tree_k2 and min(tree_k2) == m.cfg.num_layers
    if kw["spec_decode"] == "draft_model":
        # the draft decodes over its dense bf16 cache, the target verifies
        # over int8 pages: near ties may go the other way, so acceptance is
        # high but not total
        assert st.accepted_tokens > st.draft_tokens // 2
        assert k4.COUNTER.count - k4_before >= m.cfg.num_layers * len(prompts)


# ------------------------------------------------- rows that depend on M

# the generic path's (K, N): Qwen2.5's k / v projections (under the hybrid
# threshold at M <= 4), smollm-360m's (under it at M 1), and gemma-2b's
# and glm4-9b's k / v widths taken through the generic path as well
GENERIC_KN = [(896, 128), (960, 320), (2048, 256), (4096, 256)]


@pytest.mark.parametrize("k,n", GENERIC_KN)
def test_generic_path_rows_equal_across_m(cuda, k, n):
    """The generic quantized path (dequantize, then one f32 cuBLAS
    product) and a float linear in a serving step: a row's bits are the
    same whether the call holds 1 row (`generate`), 4 (a decode step),
    5, 16 or 20 (a verify step) of the same 40."""
    from repro_torch.core.qlinear import qlinear_apply
    cfg = QuantConfig(group_size=64)
    w = torch.randn(k, n, generator=cuda, device="cuda") / k ** 0.5
    p = pack_linear(*quantize_groupwise(w, cfg),
                    torch.rand(k, generator=cuda, device="cuda") + 0.5, None,
                    cfg)
    x = torch.randn(40, k, generator=cuda, device="cuda").to(torch.bfloat16)
    for fn in (lambda a: qlinear_apply(p, a, impl="ref"),
               lambda a: layers.linear({"w": w}, a)):
        full = fn(x)
        for m in (1, 4, 5, 16, 20):
            for i in range(0, 40 - m + 1, m):
                assert torch.equal(fn(x[i:i + m]), full[i:i + m]), (m, i)


def test_untied_head_rows_equal_across_m(cuda):
    """glm4-9b's untied f32 head (4096 → 151,552, never quantized): a
    row's logits are the same bits at M 1, 4, 5, 16 and 20, and equal the
    CPU's f64-summed product within f32 rounding."""
    from repro_torch.configs import get_config
    model = Model(dataclasses.replace(get_config("glm4-9b"), num_layers=1))
    params = {"lm_head": {"w": torch.randn(
        4096, 151552, generator=cuda, device="cuda") / 64}}
    x = torch.randn(40, 4096, generator=cuda, device="cuda").to(
        torch.bfloat16)
    full = model._head_logits(params, x)
    assert full.dtype == torch.float32
    for m in (1, 4, 5, 16, 20):
        for i in range(0, 40 - m + 1, m):
            assert torch.equal(model._head_logits(params, x[i:i + m]),
                               full[i:i + m]), (m, i)
    ref = model._head_logits({"lm_head": {"w": params["lm_head"]["w"][
        :, :8192].cpu()}}, x[:4].cpu())
    torch.testing.assert_close(full[:4, :8192].cpu(), ref, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------- the other dense models' shapes

# Hkv, G, hd, window: gemma3-4b's global and windowed layers, gemma-2b
# (MQA), glm4-9b, smollm-360m
K2_DENSE = [(4, 2, 256, 0), (4, 2, 256, 1024), (1, 8, 256, 0),
            (2, 16, 128, 0), (5, 3, 64, 0)]


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("hkv,g,hd,window", K2_DENSE)
def test_paged_attention_kernel_dense_model_shapes(cuda, hkv, g, hd, window,
                                                   c):
    """K2 at the other dense models' head dims and groupings, over slots
    of 96 pages of 16 (contexts up to 1,536, past gemma3's 1,024-token
    window)."""
    b, page, nblk = 4, 16, 96
    npages = b * nblk + 1
    pools = _k2_pools(cuda, npages, page, hkv, hd)
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 300, 1100, nblk * page - c], dtype=torch.int32,
                        device="cuda")
    pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                       device="cuda")[None]
    pos[0, c // 2 + 1:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    before = k2.COUNTER.count
    out = _k2_run(q, pools, table, pos, window=window)
    assert k2.COUNTER.count == before + 1
    assert out[3].abs().sum() > 0


# b, h, hkv, s, hd, causal, window
K4_DENSE = [(1, 8, 4, 1100, 256, True, 0),      # gemma3 global layer
            (1, 8, 4, 1100, 256, True, 1024),   # gemma3 windowed layer
            (2, 8, 4, 64, 256, True, 1024),     # gemma3 calibration
            (2, 8, 1, 300, 256, True, 0),       # gemma-2b (MQA)
            (1, 32, 2, 257, 128, True, 0),      # glm4-9b (g = 16)
            (1, 15, 5, 200, 64, True, 0),       # smollm-360m (g = 3)
            (1, 8, 4, 130, 256, False, 0)]      # hd 256, bidirectional


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window", K4_DENSE)
def test_flash_attention_kernel_dense_model_shapes(cuda, b, h, hkv, s, hd,
                                                   causal, window, dtype):
    q, k, v = _k4_inputs(cuda, b, h, hkv, s, hd, dtype)
    before = k4.COUNTER.count
    out = k4.flash_attention(q, k, v, causal=causal, window=window)
    ref = k4.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k4.COUNTER.count == before + 1
    _k4_check(out, ref, dtype)


def test_flash_attention_kernel_hd256_strided_views(cuda):
    """hd 256 read through ``transpose(1, 2)`` views of [B, S, H, hd]
    projections, as `attention()` passes them."""
    b, s, h, hkv, hd = 2, 77, 8, 4, 256
    qs, ks, vs = (torch.randn(b, s, n, hd, generator=cuda, device="cuda")
                  .to(torch.bfloat16) for n in (h, hkv, hkv))
    q, k, v = (t.transpose(1, 2) for t in (qs, ks, vs))
    out = k4.flash_attention(q, k, v, window=32)
    ref = k4.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=32)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    _k4_check(out, ref, torch.bfloat16)


# the other dense models' K1 (K, N): smollm-360m's q / o, k / v and down,
# gemma3-4b's q, k / v, o and GeGLU gate / up and down, glm4-9b's k / v
K1_DENSE = [(960, 960), (960, 320), (2560, 960), (2560, 2048), (2560, 1024),
            (2048, 2560), (2560, 10240), (10240, 2560), (4096, 256),
            (2048, 256)]


@pytest.mark.parametrize("m", [1, 4, 64, 1024])
@pytest.mark.parametrize("k,n", K1_DENSE)
def test_awq_matmul_kernel_dense_model_shapes(cuda, k, n, m):
    w, scale = _k1_linear(cuda, k, n, 64, True)
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        _k1_check(*_k1_run(x, w, scale, out_dtype))


@pytest.mark.parametrize("k,n", [(960, 2560), (4096, 13696)])
def test_awq_gateup_kernel_dense_model_shapes(cuda, k, n):
    """K3 at smollm-360m's and glm4-9b's SiLU fronts (K 960 is 7.5 of the
    summation rule's 128-k spans), and its rows equal across M."""
    args, scales = _k3_pair(cuda, k, n, 64, True)
    x = torch.randn(1024, k, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(input_scales=scales, out_dtype=out_dtype)
        full = k1.awq_gateup(x, *args, **kw)
        _k3_check(full, k1.awq_gateup_ref(x, *args, torch.bfloat16, **kw))
        for m in (1, 4, 64):
            part = k1.awq_gateup(x[:m].contiguous(), *args, **kw)
            _k3_check(part, k1.awq_gateup_ref(x[:m].contiguous(), *args,
                                              torch.bfloat16, **kw))
            assert torch.equal(part, full[:m]), m


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-2b", "gemma3-4b",
                                  "glm4-9b"])
def test_dense_smoke_chunk_step_on_card_near_cpu(cuda, arch):
    """Each model's smoke config, RTN int4, through two chunk steps over
    int8 pools on the card (K1 / K3, K2) and on the CPU (plain versions):
    logits within 5% of their largest magnitude (bf16 activations round
    differently once K2 dequantizes in f32). glm4-9b's smoke config runs
    at its own head dim, 32."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    assert cfg.head_dim in k2.HEAD_DIMS
    m = Model(cfg)
    params, _ = quantize_params(m.init(cuda, device="cuda"))
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(3)
    table = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 3, 8)).astype(np.int32))
    pos = [torch.full((3, 8), -1, dtype=torch.int32) for _ in range(2)]
    pos[0][0], pos[0][1, :5] = torch.arange(8), torch.arange(5)
    pos[1][0], pos[1][1, 0] = torch.arange(8, 16), 5
    sidx = [torch.tensor([7, 4, 0], dtype=torch.int32),
            torch.tensor([7, 0, 0], dtype=torch.int32)]
    pools = {d: m.init_paged_cache(13, 8, kv_quant="int8", device=d)
             for d in ("cuda", "cpu")}
    prm = {"cuda": params, "cpu": cpu_params}
    for step in range(2):
        logits = {}
        for d in ("cuda", "cpu"):
            with torch.no_grad():
                lg, pools[d] = m.chunk_step(
                    prm[d], pools[d], toks[step].to(d), pos[step].to(d),
                    sidx[step].to(d), page_table=table.to(d))
            logits[d] = lg[:2].float().cpu()
        ref = logits["cpu"]
        assert float((logits["cuda"] - ref).abs().max()) <= \
            0.05 * float(ref.abs().max())


def _tree_to(tree, device):
    from repro_torch.core.packing import PackedLinear
    if isinstance(tree, PackedLinear):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def test_gemma3_smoke_ring_decode_on_card_near_cpu(cuda):
    """gemma3-4b's smoke config (window 32, RTN int4, f32 activations)
    decoding on the card past its rings' wrap (prompt 40, then 24 steps):
    K4 prefills every layer, the windowed layers write slot pos % 32 and
    read what their rings hold; the logits stay within 2% of their scale
    of the same steps on CPU copies (plain versions), each step fed the
    CPU's token. Every linear rounds its f32 input to bf16, so a sum a
    few ulps off on one side can round an input to the neighbouring bf16
    value (2^-8): a 0.1% bound failed on the card, at 0.48% of the scale;
    a ring slot read at the wrong position moves them by far more."""
    from repro_torch.configs import get_smoke_config
    m = Model(dataclasses.replace(get_smoke_config("gemma3-4b"),
                                  activation_dtype="float32"))
    params, _ = quantize_params(m.init(cuda, device="cuda"))
    prm = {"cuda": params, "cpu": _tree_to(params, "cpu")}
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (1, 40)).astype(np.int32))
    state = {}
    with torch.no_grad():
        for d in ("cuda", "cpu"):
            cache = m.init_cache(1, 64, dtype=torch.float32, device=d)
            before = k4.COUNTER.count
            cache, lg, pos = m.prefill(prm[d], {"tokens": prompt.to(d)},
                                       cache)
            if d == "cuda":
                assert k4.COUNTER.count - before == m.cfg.num_layers
            state[d] = [cache, lg, pos]
        for _ in range(24):
            ref = state["cpu"][1].float()
            got = state["cuda"][1].float().cpu()
            assert float((got - ref).abs().max()) <= \
                2e-2 * float(ref.abs().max())
            tok = ref.argmax(-1).to(torch.int32)
            for d in ("cuda", "cpu"):
                cache, _, pos = state[d]
                lg, cache = m.decode_step(prm[d], cache, tok.to(d), pos)
                state[d] = [cache, lg, pos + 1]
    assert int(state["cpu"][2][0]) == 64


# --------------------------------------------------------------- K4b, train
# K4b (flash attention backward) against its plain version from the same
# forward output and lse (K4's): f32 math on both sides, outputs rounded
# once to the input type, so a bf16 gradient is held within 2e-2 of that
# output's largest magnitude, an f16 one within 2.5e-3 (the same five
# units in the last place at f16's 11 significant bits, where bf16 has
# 8), an f32 one within 1e-4 (another order of f32 sums over up to 1,400
# keys and 8 heads).
K4B_CASES = [
    # b, h, hkv, s, hd, causal, window
    (2, 14, 2, 512, 64, True, 0),       # Qwen2.5's train shape (G 7)
    (1, 14, 2, 17, 64, True, 0),
    (1, 14, 2, 1, 64, True, 0),
    (1, 4, 2, 77, 64, False, 0),        # bidirectional
    (1, 4, 2, 512, 128, True, 0),       # G 2, hd 128
    (1, 4, 2, 1400, 128, True, 256),    # windowed
    (1, 8, 1, 512, 256, True, 0),       # G 8, hd 256
    (1, 8, 4, 1400, 256, True, 1024),   # gemma3's windowed layers
    (1, 8, 1, 17, 256, True, 8),
    # S that cut the tensor-core body's tiles (32 keys, 32 / 64 queries)
    # mid-tile
    (1, 14, 2, 65, 64, True, 0),
    (1, 14, 2, 1000, 64, True, 0),
    (1, 4, 2, 65, 128, True, 0),
    (1, 4, 2, 1000, 128, True, 0),
    (2, 4, 4, 300, 64, True, 0),        # G 1 (h == hkv)
    (1, 2, 2, 200, 256, True, 0),       # G 1, hd 256
    (1, 4, 2, 333, 64, False, 64),      # bidirectional, windowed
    # hd 80 / 96 (two shared-memory panels, the second partly used)
    (1, 4, 4, 333, 80, False, 0),       # hubert-xlarge: bidirectional
    (1, 4, 4, 65, 96, True, 0),         # phi-3-vision, ragged S
    (1, 4, 4, 1000, 96, True, 0),
    (1, 25, 5, 1400, 64, True, 1024),   # hymba: G 5, windowed
]


def _k4b_run(cuda, b, h, hkv, s, hd, causal, window, dtype):
    q, k, v = (torch.randn(b, s, n, hd, generator=cuda, device="cuda")
               .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
    do = torch.randn(b, h, s, hd, generator=cuda, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window)
    out, lse = k4._forward(q, k, v, hd ** -0.5, causal, window, True)
    return (q, k, v, out, lse, do), kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window", K4B_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, h, hkv, s, hd,
                                                  causal, window, dtype):
    args, kw = _k4b_run(cuda, b, h, hkv, s, hd, causal, window, dtype)
    before = k4.BWD_COUNTER.count
    got = k4.flash_attention_bwd(*args, **kw)
    again = k4.flash_attention_bwd(*args, **kw)
    want = k4.flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    assert k4.BWD_COUNTER.count == before + 2
    bound = {torch.bfloat16: 2e-2, torch.float16: 2.5e-3,
             torch.float32: 1e-4}[dtype]
    dv_scale = float(want[2].float().abs().max())
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name                  # two calls, same bits
        # at S 1 (one key: P = 1, dS = dO.v - dO.o) dq and dk are exactly 0,
        # and both sides give the rounding noise of that difference: they
        # are held against dv's scale (|dO|), the size of its terms
        scale = float(w.float().abs().max()) if s > 1 else dv_scale
        err = float((g.float() - w.float()).abs().max())
        assert err <= bound * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_bwd_rows_equal_across_batch(cuda, dtype):
    """A batch row's dq, dk and dv do not depend on the batch around it:
    each row of a B 8 call equals, bit for bit, the same row computed in a
    B 1 call (Qwen2.5's heads, a ragged S)."""
    args, kw = _k4b_run(cuda, 8, 14, 2, 200, 64, True, 0, dtype)
    full = k4.flash_attention_bwd(*args, **kw)
    for i in range(8):
        one = k4.flash_attention_bwd(*(t[i:i + 1] for t in args), **kw)
        for name, f, o in zip(("dq", "dk", "dv"), full, one):
            assert torch.equal(f[i:i + 1], o), (i, name)


def test_flash_attention_bwd_rejects_misaligned_rows(cuda):
    """The tensor-core body copies 16-byte rows: a bf16 operand whose rows
    start off a 16-byte boundary is refused, not read wrongly; the f32
    body reads element by element and takes any alignment."""
    args, kw = _k4b_run(cuda, 1, 4, 2, 16, 64, True, 0, torch.bfloat16)
    for i in (0, 3, 5):                 # q, o and do
        flat = torch.zeros(args[i].numel() + 1, device="cuda",
                           dtype=torch.bfloat16)
        off = flat[1:].view(args[i].shape)
        off.copy_(args[i])
        bad = args[:i] + (off,) + args[i + 1:]
        with pytest.raises(ValueError):
            k4.flash_attention_bwd(*bad, **kw)
    args, kw = _k4b_run(cuda, 1, 4, 2, 16, 64, True, 0, torch.float32)
    flat = torch.zeros(args[5].numel() + 1, device="cuda")
    do32 = flat[1:].view(args[5].shape)
    do32.copy_(args[5])
    args = args[:5] + (do32,)
    got = k4.flash_attention_bwd(*args, **kw)
    want = k4.flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max())


def test_flash_attention_function_backward_launches_k4b(cuda):
    """Through autograd on the card: K4 once forward, K4b once backward,
    the gradients equal the bare K4b call's, and a failed build or launch
    would raise (no plain fallback on CUDA tensors)."""
    args, kw = _k4b_run(cuda, 2, 14, 2, 96, 64, True, 0, torch.bfloat16)
    q, k, v, _, _, do = args
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = k4.COUNTER.count, k4.BWD_COUNTER.count
    out = k4.flash_attention(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert (k4.COUNTER.count - f0, k4.BWD_COUNTER.count - b0) == (1, 1)
    want = k4.flash_attention_bwd(*args, **kw)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_layernorm_rows_equal_across_m(cuda):
    """A row's LayerNorm bits do not depend on how many rows share the
    call (mean and variance staged as `rmsnorm`'s mean square): the rows
    of a 20-row call equal the same rows normalized 1, 4 or 16 at a time;
    and the card is within bf16 rounding of the CPU."""
    x = (torch.randn(20, 896, generator=cuda, device="cuda") * 3 + 1
         ).to(torch.bfloat16)
    p = {"gamma": torch.rand(896, generator=cuda, device="cuda") + 0.5,
         "beta": torch.randn(896, generator=cuda, device="cuda")}
    full = layers.layernorm(p, x)
    for m in (1, 4, 16, 20):
        for i in range(0, 20 - m + 1, m):
            assert torch.equal(layers.layernorm(p, x[i:i + m]),
                               full[i:i + m]), (m, i)
    ref = layers.layernorm({k: t.cpu() for k, t in p.items()}, x.cpu())
    torch.testing.assert_close(full.cpu().float(), ref.float(), rtol=8e-3,
                               atol=8e-3)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def test_train_step_gradients_on_card_near_cpu(cuda):
    """The gradient is not cut: a 2-layer full-width Qwen2.5-0.5B step
    (bf16 activations and casts, remat on) on the card against the same
    step on CPU copies (plain versions). Every leaf, the attention's wq,
    wk, wv and their biases included, is present on both sides and within
    5 % of the leaf's largest CPU magnitude (the `check` rule: the two
    round to bf16 at other places). K4 runs twice a layer (forward and
    the remat recompute), K4b once."""
    from repro_torch.bridge import state_to_arrays
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_dataset
    from repro_torch.training.train_step import loss_and_grads, missing_grads
    cfg = dataclasses.replace(get_config("qwen25-05b"), num_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = make_dataset(cfg, 1, 64).batch_at(0)
    out = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _tree_to(params, "cpu")
        f0, b0 = k4.COUNTER.count, k4.BWD_COUNTER.count
        loss, _, grads = loss_and_grads(
            model, p, {k: torch.as_tensor(v, device=dev)
                       for k, v in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert k4.COUNTER.count - f0 == 4
            assert k4.BWD_COUNTER.count - b0 == 2
        assert missing_grads(grads) == []
        out[dev] = (float(loss), state_to_arrays(grads))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 0.05 * abs(out["cpu"][0])
    for leaf in ("wq/w", "wk/w", "wv/w", "wq/b", "wk/b", "wv/b"):
        assert f"segments/seg_0/attn/{leaf}" in out["cuda"][1]
    for path, want in out["cpu"][1].items():
        got = out["cuda"][1][path]
        assert np.isfinite(got).all(), path
        lim = 0.05 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= lim, path


# ------------------------------------------------------------ MoE family

def _experts(gen, e, k, n, gs=64):
    """E stacked RTN-packed [K, N] weights with input scales (ones as AWQ
    leaves a routed expert, plus a non-unit set)."""
    cfg = QuantConfig(group_size=gs)
    packs = [pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5, cfg),
        None, None, cfg) for _ in range(e)]
    qw, sc, zr = (torch.stack([getattr(p, f) for p in packs])
                  for f in ("qweight", "scales", "zeros"))
    return qw, sc, zr, torch.rand(e, k, generator=gen, device="cuda") + 0.5


# (E, K, F) at qwen2-moe's and deepseek-v2-lite's widths, E cut to 6 at M
# above 16 (every expert takes the same kernel)
MOE_EXPERT_CASES = [(60, 2048, 1408, 1), (60, 2048, 1408, 4),
                    (64, 2048, 1408, 5), (6, 2048, 1408, 16),
                    (6, 2048, 1408, 17), (6, 2048, 1408, 200)]


@pytest.mark.parametrize("e,k,f,m", MOE_EXPERT_CASES)
def test_expert_axis_bit_equal_to_single_calls(cuda, e, k, f, m):
    """K1 (down, F -> K) and K3 (gate / up, K -> F) over E stacked experts:
    one launch each, expert e's rows bit-equal to a call on expert e
    alone, and within K1's / K3's tolerance of the per-expert plain
    version."""
    g, u, d = (_experts(cuda, e, *kn) for kn in ((k, f), (k, f), (f, k)))
    x = torch.randn(e, m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    kw = dict(input_scales=(g[3], u[3]), out_dtype=torch.bfloat16)
    n1, n3 = k1.EXPERT_COUNTER.count, k1.GATEUP_EXPERT_COUNTER.count
    h = k1.awq_gateup_experts(x, *g[:3], *u[:3], 64, **kw)
    y = k1.awq_matmul_experts(h, *d[:3], 64, input_scale=d[3],
                              out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (k1.EXPERT_COUNTER.count, k1.GATEUP_EXPERT_COUNTER.count) == (
        n1 + 1, n3 + 1)
    assert h.shape == (e, m, f) and y.shape == (e, m, k)
    for i in range(e):
        one = k1.awq_gateup(x[i], *(t[i] for t in g[:3]),
                            *(t[i] for t in u[:3]), 64,
                            input_scales=(g[3][i], u[3][i]),
                            out_dtype=torch.bfloat16)
        assert torch.equal(h[i], one), i
        assert torch.equal(y[i], k1.awq_matmul(
            h[i], *(t[i] for t in d[:3]), 64, input_scale=d[3][i],
            out_dtype=torch.bfloat16)), i
    _k3_check(h, k1.awq_gateup_experts_ref(
        x, *g[:3], *u[:3], 64, torch.bfloat16, **kw))
    _k1_check(y, k1.awq_matmul_experts_ref(
        h, *d[:3], 64, torch.bfloat16, input_scale=d[3],
        out_dtype=torch.bfloat16))


def test_expert_axis_no_rows_counts_nothing(cuda):
    """An E x 0 x K call over stacked experts launches nothing: it returns
    an empty [E, 0, N] and leaves all four launch counters as they were."""
    g, u, d = (_experts(cuda, 4, *kn) for kn in ((256, 128), (256, 128),
                                                 (128, 256)))
    x = torch.zeros(4, 0, 256, device="cuda", dtype=torch.bfloat16)
    counters = (k1.COUNTER, k1.GATEUP_COUNTER, k1.EXPERT_COUNTER,
                k1.GATEUP_EXPERT_COUNTER)
    before = [c.count for c in counters]
    h = k1.awq_gateup_experts(x, *g[:3], *u[:3], 64,
                              input_scales=(g[3], u[3]))
    y = k1.awq_matmul_experts(h, *d[:3], 64, input_scale=d[3])
    torch.cuda.synchronize()
    assert h.shape == (4, 0, 128) and y.shape == (4, 0, 256)
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("k,n", [(10944, 2048), (2048, 576), (512, 4096),
                                 (2048, 3072)])
def test_awq_matmul_kernel_deepseek_shapes(cuda, k, n):
    """deepseek-v2-lite's K1 shapes: the dense layer's down (K 10,944, a
    short last span of 64), kv_down (N 576), kv_up (K 512) and q_proj;
    against the plain version, and the rows of M 1024 equal the same rows
    at M 1 … 64."""
    w, scale = _k1_linear(cuda, k, n, 64, True)
    x = torch.randn(1024, k, generator=cuda, device="cuda").to(torch.bfloat16)
    full, ref = _k1_run(x, w, scale, torch.bfloat16)
    _k1_check(full, ref)
    for m in (1, 4, 17, 64):
        out, ref = _k1_run(x[:m], w, scale, torch.bfloat16)
        _k1_check(out, ref)
        assert torch.equal(out, full[:m]), m


def test_moe_rows_equal_across_token_counts(cuda):
    """A qwen2-moe MoE layer at full width (60 experts, top-4, shared
    experts, RTN int4), bf16 activations: the rows of a call over 1, 4, 5
    and 16 tokens equal the same rows of a 20-token call bit for bit, as a
    serving row must whatever its step holds."""
    cfg = dataclasses.replace(qwen2_moe_a27b.config(), num_layers=1)
    p, _ = quantize_params({"moe": moe.moe_init(cuda, cfg, device="cuda")})
    x = torch.randn(20, cfg.d_model, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    before = k1.GATEUP_EXPERT_COUNTER.count
    full, _ = moe.moe_apply(p["moe"], x, cfg)
    assert k1.GATEUP_EXPERT_COUNTER.count == before + 1
    for t in (1, 4, 5, 16):
        assert torch.equal(moe.moe_apply(p["moe"], x[:t], cfg)[0],
                           full[:t]), t


@pytest.mark.parametrize("packed", [False, True], ids=["float", "int4"])
def test_mla_decode_rows_equal_across_slots_and_cache_lengths(cuda, packed):
    """deepseek-v2-lite's absorbed MLA decode at full width, bf16
    activations, every quantized linear on K1: each row of a 4-slot step
    over a 96-position latent cache equals bit for bit the same row
    decoded alone over caches of 96 and of 300 positions (a one-shot
    engine's slots against generate()'s longer cache)."""
    cfg = deepseek_v2_lite.config()
    p = mla.mla_init(cuda, cfg, device="cuda")
    if packed:
        p = quantize_params({"mla": p})[0]["mla"]
    pos = torch.tensor([0, 7, 40, 95], device="cuda")
    ckv, kpe = (torch.randn(4, 300, w, generator=cuda, device="cuda").to(
        torch.bfloat16) for w in (cfg.kv_lora_rank, cfg.qk_rope_head_dim))
    x = torch.randn(4, cfg.d_model, generator=cuda,
                    device="cuda").to(torch.bfloat16)

    def run(rows, s):
        cache = {"ckv": ckv[rows, :s].clone(), "kpe": kpe[rows, :s].clone()}
        with execution_config(ExecutionConfig(offload_min_flops=0)):
            y, cache = mla.mla_decode(p, cache, x[rows], cfg, pos=pos[rows])
        return y, cache

    full, cache = run(slice(None), 96)
    assert full.shape == (4, cfg.d_model) and torch.isfinite(full).all()
    for s in (96, 300):
        for i in range(4):
            y, one = run(slice(i, i + 1), s)
            assert torch.equal(y[0], full[i]), (s, i)
            assert torch.equal(one["ckv"][0, :96], cache["ckv"][i]), (s, i)


@pytest.mark.parametrize("c", [1, 16])
def test_paged_attention_kernel_mha_hd128(cuda, c):
    """K2 at G = 1 and hd 128 with 16 kv heads (qwen2-moe's MHA): one query
    row a kv head, packed alone into its 8-row group."""
    b, hkv, hd, page, nblk = 4, 16, 128, 16, 40
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 37, 300, nblk * page - c], dtype=torch.int32,
                        device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[2, c // 2 + 1:] = -1
    q = torch.randn(b, c, hkv, 1, hd, generator=cuda, device="cuda")
    _k2_run(q, pools, table, pos)


@pytest.mark.parametrize("s", [64, 300, 1024])
def test_flash_attention_kernel_mha_hd128(cuda, s):
    """K4 at G = 1 and hd 128 (qwen2-moe: 16 q over 16 kv heads) on
    ``transpose(1, 2)`` views, bf16, causal: the launcher's and the
    one-shot engine's prefills."""
    q, k, v = (torch.randn(2, s, 16, 128, generator=cuda, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    out = k4.flash_attention(q, k, v, causal=True)
    ref = k4.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    torch.cuda.synchronize()
    _k4_check(out, ref, torch.bfloat16)


# ----------------------------------------- the SSM and hybrid families

# K1 (K, N) of mamba2-130m (wz / wx, wb / wc, wdt, out_proj) and
# hymba-1.5b (q / o, k / v, the SSM's wz / wx, its wb / wc, its out_proj,
# the MLP's down): N 16 and 24 fill less than one 64-column block
K1_SSM = [(768, 1536), (768, 128), (768, 24), (1536, 768),
          (1600, 1600), (1600, 320), (1600, 3200), (1600, 16),
          (3200, 1600), (5504, 1600)]


@pytest.mark.parametrize("k,n", K1_SSM)
def test_awq_matmul_kernel_ssm_shapes(cuda, k, n):
    """K1 at the two models' shapes, M 1, 4, 64 and 1,024, both outputs,
    against its plain version; the rows of each smaller M equal the same
    rows of the 1,024-row call (the column guards of the decode and the
    wide forms)."""
    w, scale = _k1_linear(cuda, k, n, 64, True)
    x = torch.randn(1024, k, generator=cuda, device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        full, ref = _k1_run(x, w, scale, out_dtype)
        _k1_check(full, ref)
        for m in (1, 4, 64):
            part, ref = _k1_run(x[:m].contiguous(), w, scale, out_dtype)
            _k1_check(part, ref)
            assert torch.equal(part, full[:m]), (m, out_dtype)


def test_awq_gateup_kernel_hymba_shape(cuda):
    """K3 at hymba's SiLU front (1600 -> 5504), M 1, 4, 64 and 1,024."""
    args, scales = _k3_pair(cuda, 1600, 5504, 64, True)
    x = torch.randn(1024, 1600, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(input_scales=scales, out_dtype=out_dtype)
        full = k1.awq_gateup(x, *args, **kw)
        _k3_check(full, k1.awq_gateup_ref(x, *args, torch.bfloat16, **kw))
        for m in (1, 4, 64):
            part = k1.awq_gateup(x[:m].contiguous(), *args, **kw)
            assert torch.equal(part, full[:m]), m


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("window", [0, 1024])
def test_paged_attention_kernel_hymba_g5(cuda, window, c):
    """K2 at hymba's grouping, 5 kv heads of 5 query heads (G 5), hd 64,
    over slots of 96 pages of 16 (contexts up to 1,536), with and without
    a window."""
    b, hkv, g, hd, page, nblk = 4, 5, 5, 64, 16, 96
    npages = b * nblk + 1
    pools = _k2_pools(cuda, npages, page, hkv, hd)
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([16, 700, 1400, nblk * page - c], dtype=torch.int32,
                        device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[0, c // 2 + 1:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    before = k2.COUNTER.count
    out = _k2_run(q, pools, table, pos, window=window)
    assert k2.COUNTER.count == before + 1
    assert out[2].abs().sum() > 0


# b, h, hkv, s, hd, causal, window: hymba's prefills (25 q over 5 kv
# heads, G 5): the engine's longest one-shot prompt on a global and a
# windowed layer, the launcher's batch, the calibration forward
K4_HYMBA = [(1, 25, 5, 1400, 64, True, 0), (1, 25, 5, 1400, 64, True, 1024),
            (2, 25, 5, 1100, 64, True, 1024), (2, 25, 5, 64, 64, True, 1024)]


@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window", K4_HYMBA)
def test_flash_attention_kernel_hymba_g5(cuda, b, h, hkv, s, hd, causal,
                                         window):
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _k4_inputs(cuda, b, h, hkv, s, hd, torch.bfloat16))
    before = k4.COUNTER.count
    out = k4.flash_attention(q, k, v, causal=causal, window=window)
    ref = k4.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal, window=window)
    torch.cuda.synchronize()
    assert k4.COUNTER.count == before + 1
    _k4_check(out, ref, torch.bfloat16)


def _ssm_block(gen, name: str, packed: bool):
    """A full-width block of ``name`` (mamba2's, or hymba's first windowed
    one), bf16 activations, float or RTN int4 (every quantizable linear),
    and a dense cache of 5 slots holding random state (hymba's ring full,
    positions past its window)."""
    cfg = (mamba2_130m if name == "mamba2-130m" else hymba_15b).config()
    kind = [k for k in cfg.layer_kinds() if k.window or k.mixer == "mamba"][0]
    p = blocks.block_init(gen, cfg, kind, device="cuda")
    if packed:
        p = quantize_params({"block": p})[0]["block"]
    cache = blocks.init_block_cache(cfg, kind, 5, 2048, torch.bfloat16,
                                    device="cuda")
    for entry in cache.values():
        for key, leaf in entry.items():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda")
                       * (0.3 if key in ("state", "conv_x") else 1.0))
    return cfg, kind, p, cache


@pytest.mark.parametrize("packed", [False, True], ids=["float", "int4"])
@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_decode_rows_equal_across_slots(cuda, name, packed):
    """A decode step of a full-width mamba2 or hymba block (SSD recurrence,
    conv steps, gated norm; hymba's ring attention and branch norms
    beside it), every quantized linear on K1: each row of a 5-slot step,
    output and new state, equals bit for bit the same row in a 4-slot
    step and alone (a one-shot engine's slots against generate()'s
    B 1)."""
    cfg, kind, p, cache = _ssm_block(cuda, name, packed)
    x = torch.randn(5, cfg.d_model, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    pos = torch.tensor([1100, 1500, 1030, 2000, 1200], dtype=torch.int32,
                       device="cuda")

    def run(rows):
        c = {e: {k: v[rows].clone() for k, v in leaves.items()}
             for e, leaves in cache.items()}
        with execution_config(ExecutionConfig(offload_min_flops=0)):
            y, c, _ = blocks.block_apply(p, x[rows], cfg, kind, mode="decode",
                                         positions=pos[rows], cache=c)
        return y, c

    full, fc = run(slice(None))
    assert torch.isfinite(full).all()
    for rows in [slice(0, 4)] + [slice(i, i + 1) for i in range(5)]:
        y, c = run(rows)
        assert torch.equal(y, full[rows]), rows
        for e, leaves in c.items():
            for k, v in leaves.items():
                assert torch.equal(v, fc[e][k][rows]), (rows, e, k)


def test_hymba_ring_decode_rows_equal_across_slots(cuda):
    """hymba's windowed attention decode over per-slot rings of 1,024
    positions (5 kv heads, G 5, hd 64), float weights: each row of a
    5-slot step equals bit for bit the same row in a 4-slot step and
    alone, the rings written at ``pos % window``."""
    cfg = hymba_15b.config()
    p = attention.attn_init(cuda, cfg, device="cuda")
    ring = attention.init_kv_cache(cfg, 5, 2048, cfg.sliding_window,
                                   torch.bfloat16, device="cuda")
    for leaf in ring.values():
        leaf.copy_(torch.randn(leaf.shape, generator=cuda, device="cuda"))
    x = torch.randn(5, cfg.d_model, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    pos = torch.tensor([1100, 1500, 1030, 2000, 700], dtype=torch.int32,
                       device="cuda")

    def run(rows):
        c = {k: v[rows].clone() for k, v in ring.items()}
        return attention.attention_decode(p, c, x[rows], cfg, pos=pos[rows],
                                          window=cfg.sliding_window)

    full, fc = run(slice(None))
    for rows in [slice(0, 4)] + [slice(i, i + 1) for i in range(5)]:
        y, c = run(rows)
        assert torch.equal(y, full[rows]), rows
        assert all(torch.equal(c[k], fc[k][rows]) for k in c), rows


# ------------------------------- the encoder and the vision frontend

# K4 at hubert-xlarge's (16 heads of 80, bidirectional) and phi-3-vision's
# (32 heads of 96, causal) widths, each under both masks
K4_FRONTEND = [(16, 80), (32, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1000, 1023])
@pytest.mark.parametrize("h,hd", K4_FRONTEND)
def test_flash_attention_kernel_hd80_hd96(cuda, h, hd, s, causal, dtype):
    """K4 at head dims 80 and 96, MHA, S 1,000 and 1,023 (every 64-row
    tile but the last whole, so rows 60 … 63 of each tile are live), bf16
    and f32, on ``transpose(1, 2)`` views of [B, S, H, hd] projections as
    `attention()` passes them: every element within the K4 tolerance of
    the plain version, one launch, the output in q's layout."""
    b = 2
    q, k, v = (torch.randn(b, s, h, hd, generator=cuda, device="cuda")
               .to(dtype).transpose(1, 2) for _ in range(3))
    before = k4.COUNTER.count
    out = k4.flash_attention(q, k, v, causal=causal)
    ref = k4.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal)
    torch.cuda.synchronize()
    assert k4.COUNTER.count == before + 1
    assert out.stride() == q.stride()
    _k4_check(out, ref, dtype)


@pytest.mark.parametrize("hd", [80, 96])
def test_flash_attention_kernel_hd80_hd96_deterministic(cuda, hd):
    """Two calls give the same bits, and each batch row's output equals a
    B 1 call's (the encoder's forward against `check_prefill`'s B 1)."""
    q, k, v = _k4_inputs(cuda, 2, 16, 16, 1023, hd, torch.bfloat16)
    runs = [k4.flash_attention(q, k, v, causal=False) for _ in range(2)]
    one = k4.flash_attention(q[1:].contiguous(), k[1:].contiguous(),
                             v[1:].contiguous(), causal=False)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][1:], one)


def test_flash_attention_bwd_refuses_head_dims_it_is_not_built_for(cuda):
    """K4b is built for hd 32, 64, 80, 96, 128 and 256 only: at 48 and 112
    (the output and lse from the plain forward, which K4 does not take
    either) its wrapper raises rather than launching."""
    assert k4.BWD_HEAD_DIMS == (32, 64, 80, 96, 128, 256)
    for hd in (48, 112):
        q, k, v = _k4_inputs(cuda, 1, 2, 2, 64, hd, torch.bfloat16)
        out, lse = k4.flash_attention_lse_ref(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head_dim"):
            k4.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("window", [0, 128])
def test_paged_attention_kernel_phi3_hd96(cuda, window, c):
    """K2 at phi-3-vision's 32 kv heads of 96 (G 1), over slots of 32
    pages of 16 (contexts up to 512, the engine's max_seq), with and
    without a window: its 6 chunks of 16 bytes a key row stay inside the
    row (a rotation, not an XOR)."""
    b, hkv, g, hd, page, nblk = 4, 32, 1, 96, 16, 32
    npages = b * nblk + 1
    pools = _k2_pools(cuda, npages, page, hkv, hd)
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([16, 200, 456, nblk * page - c], dtype=torch.int32,
                        device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[0, c // 2 + 1:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    before = k2.COUNTER.count
    out = _k2_run(q, pools, table, pos, window=window)
    assert k2.COUNTER.count == before + 1
    assert out[3].abs().sum() > 0


@pytest.mark.parametrize("window", [0, 128])
def test_paged_attention_kernel_hd96_tree_rows(cuda, window):
    """A token-tree verify row at hd 96 (Hkv 4, G 2): logical positions,
    the ancestor closure as ``amask``, one node that sees nothing (0)."""
    parents = [-1, 0, 1, 2, 0, 4, 1, 6]
    c, b, hkv, g, hd, page, nblk = len(parents), 3, 4, 2, 96, 16, 32
    anc = torch.zeros(c, c, dtype=torch.bool)
    depth = [0] * c
    for j, par in enumerate(parents):
        if par >= 0:
            anc[j], depth[j] = anc[par], depth[par] + 1
        anc[j, j] = True
    pools = _k2_pools(cuda, b * nblk + 1, page, hkv, hd)
    table = (torch.randperm(b * nblk, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 137, 300], dtype=torch.int32, device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    rpos = (base[:, None] + torch.tensor(depth, dtype=torch.int32,
                                         device="cuda")[None]).contiguous()
    amask = anc[None].repeat(b, 1, 1).cuda()
    amask[0, 5] = False
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    out = _k2_run(q, pools, table, pos, rpos=rpos, amask=amask,
                  window=window)
    assert not out[0, 5].any() and out[1].abs().sum() > 0


# K1 (K, N) of hubert-xlarge (q / k / v / o, up, down, frame_proj) and
# phi-3-vision (q / k / v / o, down)
K1_FRONTEND = [(1280, 1280), (1280, 5120), (5120, 1280), (512, 1280),
               (3072, 3072), (8192, 3072)]


@pytest.mark.parametrize("k,n", K1_FRONTEND)
def test_awq_matmul_kernel_frontend_model_shapes(cuda, k, n):
    """K1 at the two models' shapes, M 1, 4, 64 and 2,048 (hubert's
    forward of B 2 × S 1,024), both outputs, against its plain version;
    the rows of each smaller M equal the same rows of the 2,048-row
    call."""
    w, scale = _k1_linear(cuda, k, n, 64, True)
    x = torch.randn(2048, k, generator=cuda, device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        full, ref = _k1_run(x, w, scale, out_dtype)
        _k1_check(full, ref)
        for m in (1, 4, 64):
            part, ref = _k1_run(x[:m].contiguous(), w, scale, out_dtype)
            _k1_check(part, ref)
            assert torch.equal(part, full[:m]), (m, out_dtype)


def _k3_past_tolerance(out, ref) -> int:
    """Elements of a bf16 K3 output past `_k3_check`'s four bf16 ulps."""
    err = (out.float() - ref.float()).abs()
    lim = 1e-5 * float(ref.float().abs().max()) + 2 ** -6 * ref.float().abs()
    return int((err > lim).sum())


def test_awq_gateup_kernel_phi3_shape(cuda):
    """K3 at phi-3-vision's SiLU front (3072 -> 8192), M 1, 4, 64 and
    1,024, rows equal across M in both outputs. The f32 output is held at
    `_k3_check`'s tolerance everywhere. The bf16 output rounds g to bf16
    before silu, and over 8.4 M elements a g a few f32 ulps from a bf16
    midpoint rounds the other way, which silu's slope carries past four
    bf16 ulps of the product (ROADMAP, Reference caveats,
    "Cross-framework numerics"; chip_smoke.py counts them): at most one
    element in 10^5 may be past them."""
    args, scales = _k3_pair(cuda, 3072, 8192, 64, True)
    x = torch.randn(1024, 3072, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(input_scales=scales, out_dtype=out_dtype)
        full = k1.awq_gateup(x, *args, **kw)
        ref = k1.awq_gateup_ref(x, *args, torch.bfloat16, **kw)
        if out_dtype == torch.float32:
            _k3_check(full, ref)
        else:
            assert _k3_past_tolerance(full, ref) <= full.numel() // 10**5
        for m in (1, 4, 64):
            part = k1.awq_gateup(x[:m].contiguous(), *args, **kw)
            assert torch.equal(part, full[:m]), m


@pytest.mark.parametrize("cfg", [glm4_9b.config(), qwen2_moe_a27b.config()],
                         ids=["glm4-9b", "qwen2-moe-a2.7b"])
def test_decode_attention_rows_equal_across_slots_and_lengths(cuda, cfg):
    """A full-width attention layer's decode read over bf16 pages (the
    one-shot engine's `attention_decode_paged`, 24 pages of 16 a slot):
    each row of a 5-slot step equals bit for bit the same row in a
    4-slot step and alone, and the row `attention_decode` gives over a
    dense cache of 512 positions holding the same keys (`generate()` at
    B 1). glm4-9b (32 q over 2 kv heads of 128) and qwen2-moe-a2.7b (16
    heads of 128): in f32 on the card these rows parted, and with them 3
    of 8 greedy streams of each (`scripts/queue3_oneshot_bf16.py`)."""
    p = attention.attn_init(cuda, cfg, device="cuda")
    hkv, hd, page, nblk = cfg.num_kv_heads, cfg.head_dim, 16, 24
    npages = 5 * nblk + 1
    pool = {k: torch.randn(npages, page, hkv, hd, generator=cuda,
                           device="cuda").to(torch.bfloat16)
            for k in ("k", "v")}
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(5, nblk)
    x = torch.randn(5, cfg.d_model, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    pos = torch.tensor([100, 300, 57, 383, 200], dtype=torch.int32,
                       device="cuda")

    def paged(rows):
        pl = {k: v.clone() for k, v in pool.items()}
        return attention.attention_decode_paged(
            p, pl, table[rows].contiguous(), x[rows], cfg, pos=pos[rows])[0]

    full = paged(slice(None))
    assert torch.isfinite(full.float()).all()
    for rows in [slice(0, 4)] + [slice(i, i + 1) for i in range(5)]:
        assert torch.equal(paged(rows), full[rows]), rows
    for i in range(5):
        cache = {k: torch.zeros(1, 512, hkv, hd, dtype=torch.bfloat16,
                                device="cuda") for k in ("k", "v")}
        for k in cache:
            cache[k][0, :nblk * page] = pool[k][table[i].long()].reshape(
                nblk * page, hkv, hd)
        y, _ = attention.attention_decode(p, cache, x[i:i + 1], cfg,
                                          pos=pos[i:i + 1])
        assert torch.equal(y, full[i:i + 1]), i


# ------------------------------------------------- tensor parallelism

def _k2_tp_case(cuda, case: str):
    """Qwen2.5's decode shape (Hkv 2, G 7, hd 64, page 16, B 4, contexts
    to 512 with a padding row), C 1 and 16; C 8 with a token tree's
    ancestor mask, logical positions and a 128-token window."""
    b, hkv, g, hd, page, nblk = 4, 2, 7, 64, 16, 32
    c = {"decode": 1, "chunk": 16, "tree": 8}[case]
    npages = b * nblk + 1
    kp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=cuda,
                       device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=cuda,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand(npages, page, hkv, generator=cuda, device="cuda") / 50
    vs = torch.rand(npages, page, hkv, generator=cuda, device="cuda") / 50
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([0, 137, 300, 512 - c], dtype=torch.int32,
                        device="cuda")
    pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                       device="cuda")[None]
    pos[0] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    kw = {}
    if case == "tree":
        parents = [-1, 0, 1, 2, 0, 4, 1, 6]
        anc = torch.zeros(c, c, dtype=torch.bool)
        depth = [0] * c
        for j, par in enumerate(parents):
            if par >= 0:
                anc[j] = anc[par]
                depth[j] = depth[par] + 1
            anc[j, j] = True
        amask = (anc[None].expand(b, c, c).to("cuda")
                 & (pos >= 0)[:, None, :]).contiguous()
        rpos = torch.where(pos >= 0, pos[:, :1] + torch.tensor(
            depth, dtype=torch.int32, device="cuda")[None], pos)
        kw = dict(rpos=rpos.to(torch.int32).contiguous(), amask=amask,
                  window=128)
    return q, (kp, ks, vp, vs), table, pos, kw


@pytest.mark.parametrize("case", ["decode", "chunk", "tree"])
def test_k2_tp_bit_equal_to_k2_over_all_heads(cuda, case):
    """K2-TP over a 2-way mesh on one card (1 kv head a shard, each
    stripe its own allocation): one K2 launch a shard, the shards joined
    over heads equal to one K2 launch over both heads bit for bit, and
    its plain version within K2's tolerance."""
    from repro_torch.distributed import serving_mesh
    q, (kp, ks, vp, vs), table, pos, kw = _k2_tp_case(cuda, case)
    mesh = serving_mesh(2, devices=["cuda:0", "cuda:0"])
    cut = [[p.contiguous() for p in torch.chunk(t, 2, dim)]
           for t, dim in ((q, 2), (kp, -2), (ks, -1), (vp, -2), (vs, -1))]
    before = (k2.TP_COUNTER.count, k2.COUNTER.count)
    outs = k2.paged_attention_chunk_sharded(*cut, table, pos, mesh=mesh,
                                            **kw)
    whole = k2.paged_attention_chunk(q, kp, ks, vp, vs, table, pos, **kw)
    torch.cuda.synchronize()
    assert (k2.TP_COUNTER.count - before[0],
            k2.COUNTER.count - before[1]) == (1, 3)
    assert torch.equal(torch.cat(outs, dim=2), whole)
    ref = torch.cat(k2.paged_attention_chunk_sharded_ref(
        *cut, table, pos, mesh=mesh, **kw), dim=2)
    assert float((whole - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))
    assert not whole[0].any()                       # all-padding row


def test_k2_tp_refuses_strided_stripes(cuda):
    """A stripe must be its own contiguous pool: a view of a whole pool's
    head is refused, not read."""
    from repro_torch.distributed import serving_mesh
    q, (kp, ks, vp, vs), table, pos, _ = _k2_tp_case(cuda, "decode")
    mesh = serving_mesh(2, devices=["cuda:0", "cuda:0"])
    views = [[t[..., i:i + 1, :] for i in range(2)] for t in (kp, vp)]
    with pytest.raises(ValueError, match="contiguous"):
        k2.paged_attention_chunk_sharded(
            [p.contiguous() for p in torch.chunk(q, 2, 2)], views[0],
            [p.contiguous() for p in torch.chunk(ks, 2, -1)], views[1],
            [p.contiguous() for p in torch.chunk(vs, 2, -1)], table, pos,
            mesh=mesh)


def test_sharded_engine_on_card(smoke_engine):
    """The smoke model served over a 2-way mesh on one card, int8 pools:
    a chunk step's logits within the `check` rule of the unsharded
    step's (row-parallel sums round in another order), K2-TP once a
    layer, each shard's pools half the bytes; a spill → restore round
    trip bit for bit; every request finished, no page in use."""
    from repro_torch.distributed import serving_mesh, shard_params
    m, make = smoke_engine
    params = make().params
    mesh = serving_mesh(2, devices=["cuda:0", "cuda:0"])
    toks = torch.randint(0, m.cfg.vocab_size, (4, 8), device="cuda",
                         dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32, device="cuda")[None].repeat(4, 1)
    pos[3, 5:] = -1
    sidx = torch.tensor([7, 7, 7, 4], dtype=torch.int32, device="cuda")
    table = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(4, 2)
    plain, _ = m.chunk_step(params, m.init_paged_cache(9, 8, kv_quant="int8",
                                                      device="cuda"),
                            toks, pos, sidx, page_table=table)
    before = k2.TP_COUNTER.count
    got, _ = m.chunk_step(shard_params(params, mesh, m.cfg),
                          m.init_paged_cache(9, 8, kv_quant="int8",
                                             mesh=mesh),
                          toks, pos, sidx, page_table=table, mesh=mesh)
    assert k2.TP_COUNTER.count - before == m.cfg.num_layers
    tol = 0.05 * float(plain.float().abs().max())
    assert float((got - plain).float().abs().max()) <= tol

    eng = make(kv_quant="int8", preemption=True, mesh=mesh)
    rids = [eng.submit(np.arange(n, dtype=np.int32) * 3 % m.cfg.vocab_size,
                       6) for n in (21, 13, 30)]
    while not eng.step():
        pass
    sched = eng._scheduler
    slot = next(s for s, st in sched.slots.items()
                if st.request.rid == rids[-1])
    ids = torch.as_tensor(sched.pager.peek_spill(slot), device="cuda")
    want = {k: torch.cat([c["seg_0"][i]["kv_pool"][k][ids]
                          for c in eng._paged_cache], dim=-2
                         if k in ("k", "v") else -1).cpu()
            for i in range(m.cfg.num_layers) for k in ("k", "ks")}
    assert eng.preempt(rids[-1])
    (parked,) = sched.preempted
    parked.handle["event"].synchronize()
    strips = parked.handle["strips"]["seg_0"]
    assert all(t.is_pinned() for t in strips.values())
    assert torch.equal(strips["k"][-1], want["k"])
    assert torch.equal(strips["ks"][-1], want["ks"])
    out = eng.drain()
    st = eng.stats()
    assert st.restores == 1 and st.pager.pages_used == 0
    assert st.model_axis == 2
    assert 2 * st.kv_pool_bytes_per_device == st.kv_pool_bytes
    assert all(out[r].shape == (6,) for r in rids)


# ----------------------------------------------- MoE and training on a mesh

# one shard's stripe of qwen2-moe's 60 experts (d_model 2,048, expert
# d_ff 1,408): K3 2,048 -> F / n, K1 1,408 -> D / n, at model 2 and 4; E
# cut to 8 at M 1,024 (every expert takes the same kernel)
MOE_STRIPE_CASES = [(60, n, m) for n in (2, 4) for m in (4, 64)] \
    + [(8, n, 1024) for n in (2, 4)]


@pytest.mark.parametrize("e,n,m", MOE_STRIPE_CASES)
def test_expert_axis_shard_stripes_match_plain(cuda, e, n, m):
    """K3 and K1 over the experts at a shard's stripe widths (N 704 / 352
    and 1,024 / 512): one launch each, within K3's / K1's tolerance of
    the plain versions, bf16 output as the model calls them."""
    g, u = (_experts(cuda, e, 2048, 1408 // n) for _ in range(2))
    d = _experts(cuda, e, 1408, 2048 // n)
    x = torch.randn(e, m, 2048, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    h_in = torch.randn(e, m, 1408, generator=cuda,
                       device="cuda").to(torch.bfloat16)
    kw = dict(input_scales=(g[3], u[3]), out_dtype=torch.bfloat16)
    n1, n3 = k1.EXPERT_COUNTER.count, k1.GATEUP_EXPERT_COUNTER.count
    h = k1.awq_gateup_experts(x, *g[:3], *u[:3], 64, **kw)
    y = k1.awq_matmul_experts(h_in, *d[:3], 64, input_scale=d[3],
                              out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (k1.EXPERT_COUNTER.count, k1.GATEUP_EXPERT_COUNTER.count) == (
        n1 + 1, n3 + 1)
    assert h.shape == (e, m, 1408 // n) and y.shape == (e, m, 2048 // n)
    _k3_check(h, k1.awq_gateup_experts_ref(
        x, *g[:3], *u[:3], 64, torch.bfloat16, **kw))
    _k1_check(y, k1.awq_matmul_experts_ref(
        h_in, *d[:3], 64, torch.bfloat16, input_scale=d[3],
        out_dtype=torch.bfloat16))


def test_moe_tp_packed_layer_on_card_equals_unsharded(cuda):
    """A packed qwen2-moe smoke layer under a 2-way mesh on cuda:0 (K3 on
    each shard's F stripe, K1 on its D stripe, every linear on its
    kernel): within two bf16 ulps (and 1e-3 of the scale) of the
    unsharded layer, each expert kernel launched once a shard."""
    from repro_torch.distributed import sharding as shd
    cfg = qwen2_moe_a27b.smoke_config()
    p = moe.moe_init(cuda, cfg, device="cuda")
    qp, _ = quantize_params({"moe": p})
    x = torch.randn(4, 16, cfg.d_model, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    with execution_config(ExecutionConfig(offload_min_flops=0)):
        want, _ = moe.moe_apply(qp["moe"], x, cfg)
        mesh = shd.serving_mesh(2, devices=["cuda:0", "cuda:0"])
        shards = shd.shard_params(qp, mesh, cfg)
        before = k1.EXPERT_COUNTER.count, k1.GATEUP_EXPERT_COUNTER.count
        got, _ = moe.moe_apply_tp([s["moe"] for s in shards], x, cfg,
                                  shd.model_devices(mesh))
        torch.cuda.synchronize()
    assert (k1.EXPERT_COUNTER.count - before[0],
            k1.GATEUP_EXPERT_COUNTER.count - before[1]) == (2, 2)
    # the shared experts' row-parallel down sums two partials, rounded
    # once: a bf16 ulp or two from the unsharded product
    err = (got.float() - want.float()).abs()
    lim = 1e-3 * float(want.float().abs().max()) + 2 * _bf16_ulp(want)
    assert bool((err <= lim).all()), float((err - lim).max())


def test_mesh_train_step_on_card_near_unsharded(cuda):
    """One train step of the smoke model over (data 2 x model 2) on
    cuda:0 (K4 / K4b on each shard's heads) against the unsharded step on
    the card: f32 activations and casts, the loss and grad_norm within
    1e-4 relative; the replicas bit-equal after it."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      make_train_step)
    from repro_torch.training.train_step import init_train_state
    from repro_torch.data.pipeline import make_dataset
    cfg = dataclasses.replace(qwen25_05b.smoke_config(),
                              activation_dtype="float32")
    m = Model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=0),
                     grad_comm_dtype="float32")
    batch = make_dataset(cfg, 4, 64).batch_at(0)
    state = init_train_state(m, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
    mesh = make_host_mesh(2, 2, devices=["cuda:0"] * 4)
    placed = shd.TrainSharding(mesh, cfg).place(state)
    _, want = make_train_step(m, tc)(state, batch)
    bwd = k4.BWD_COUNTER.count
    new, got = make_train_step(m, tc, mesh=mesh)(placed, batch)
    torch.cuda.synchronize()
    assert k4.BWD_COUNTER.count > bwd
    for key in ("loss", "grad_norm"):
        assert abs(float(got[key]) - float(want[key])) \
            <= 1e-4 * abs(float(want[key])), key
    for a, b in zip(new["params"][0], new["params"][1]):
        assert all(torch.equal(x, y) for x, y in zip(
            [t for t in _tensors(a)], [t for t in _tensors(b)]))


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


# Tensor parallelism of the MLA, SSM, hybrid, encoder and VLM families:
# the kernels at the widths a 2-way `model` mesh gives a shard. K1 at N 8
# (hymba's wb / wc stripe, 16 -> 8), N 12 (mamba2's wdt, 24 -> 12) and N 25
# (hymba's wdt stripe width): output rows of 32, 48 and 100 bytes.
TP_NARROW_K1 = [(1600, 8), (768, 12), (1600, 25)]


@pytest.mark.parametrize("offload", [2.0 ** 20, 0.0],
                         ids=["default", "all_kernel"])
@pytest.mark.parametrize("m", [1, 4, 64, 128])
@pytest.mark.parametrize("k,n", TP_NARROW_K1)
def test_tp_narrow_stripes_k1_matches_plain(cuda, k, n, m, offload):
    """A packed linear at a stripe's N through `qlinear_apply` (input
    scale, bf16 output: the model's call), under the default threshold and
    with every product on K1, against the generic path: K1 where the
    threshold sends it (one launch a call), within `_k1_check`'s bounds."""
    from repro_torch.core.qlinear import qlinear_apply
    cfg = QuantConfig(group_size=64)
    w = torch.randn(k, n, generator=cuda, device="cuda") / k ** 0.5
    p = pack_linear(*quantize_groupwise(w, cfg),
                    torch.rand(k, generator=cuda, device="cuda") + 0.5,
                    None, cfg)
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    ecfg = ExecutionConfig(offload_min_flops=offload)
    before = k1.COUNTER.count
    with execution_config(ecfg):
        out = qlinear_apply(p, x)
        ref = qlinear_apply(p, x, impl="ref")
    torch.cuda.synchronize()
    kernel = 2.0 * m * k * n >= offload
    assert k1.COUNTER.count == before + kernel
    _k1_check(out, ref)
    if kernel:
        assert torch.equal(out, k1.awq_matmul(
            x, p.qweight, p.scales, p.zeros, 64, input_scale=p.input_scale,
            out_dtype=torch.bfloat16))


@pytest.mark.parametrize("m", [4, 128])
def test_tp_flipped_down_on_card_matches_unsharded(cuda, m):
    """deepseek-v2-lite's dense down (K 10,944 -> 2,048), RTN-packed with an
    AWQ-like input scale, on a 2-way mesh on cuda:0: 5,472 rows a shard
    would cut a 64-row group, so the rule flips it to its N (1,024 a
    shard); each shard scales its K slice of the input, the slices are
    joined and K1 runs once a shard on the whole input. Held against the
    unsharded linear within a bf16 ulp and 1e-4 of the scale."""
    from repro_torch.core.qlinear import qlinear_apply
    from repro_torch.distributed import sharding as shd
    cfg = deepseek_v2_lite.config()
    k, n = cfg.d_ff, cfg.d_model
    qc = QuantConfig(group_size=64)
    p = pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=cuda, device="cuda") / k ** 0.5, qc),
        torch.rand(k, generator=cuda, device="cuda") + 0.5, None, qc)
    mesh = shd.serving_mesh(2, devices=["cuda:0", "cuda:0"])
    spec = shd.param_pspec("mlp/down/qweight", p.qweight, mesh, cfg)
    assert spec == (None, "model")
    shards = shd.shard_params({"mlp": {"down": p}}, mesh, cfg)
    assert [s["mlp"]["down"].n for s in shards] == [n // 2] * 2
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    with execution_config(ExecutionConfig(offload_min_flops=0)):
        want = qlinear_apply(p, x)
        before = k1.COUNTER.count
        got = layers.linear_tp([s["mlp"]["down"] for s in shards], x,
                               shd.model_devices(mesh), k, n)
    torch.cuda.synchronize()
    assert k1.COUNTER.count == before + 2
    _k1_check(got, want)


@pytest.mark.parametrize("m", [4, 128, 1024])
@pytest.mark.parametrize("k,n", [(2048, 5472), (1600, 2752), (3072, 4096)])
def test_tp_gateup_stripes_match_plain(cuda, k, n, m):
    """K3 at the GLU fronts' column stripes of a 2-way mesh (deepseek's
    dense layer, hymba's, phi-3-vision's), both outputs, input scales."""
    args, scales = _k3_pair(cuda, k, n, 64, True)
    x = torch.randn(m, k, generator=cuda, device="cuda").to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(input_scales=scales, out_dtype=out_dtype)
        _k3_check(k1.awq_gateup(x, *args, **kw),
                  k1.awq_gateup_ref(x, *args, torch.bfloat16, **kw))


# one shard's heads: hubert-xlarge's 8 of 80 (bidirectional), phi-3-
# vision's 16 of 96 (causal, 256 patches + 256 tokens)
TP_K4_SHARD = [(2, 8, 8, 1024, 80, False, 0), (2, 16, 16, 512, 96, True, 0)]


@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window", TP_K4_SHARD)
def test_tp_shard_heads_k4_and_k4b_match_plain(cuda, b, h, hkv, s, hd,
                                               causal, window):
    """K4 (forward) and K4b (its gradient, two calls bit-equal) at one
    shard's heads, bf16, against their plain versions (`_k4_check`;
    K4b's bf16 bound, 2e-2 of each gradient's largest magnitude)."""
    q, k, v = _k4_inputs(cuda, b, h, hkv, s, hd, torch.bfloat16)
    out = k4.flash_attention(q, k, v, causal=causal, window=window)
    _k4_check(out, k4.flash_attention_ref(q, k, v, causal=causal,
                                          window=window), torch.bfloat16)
    args, kw = _k4b_run(cuda, b, h, hkv, s, hd, causal, window,
                        torch.bfloat16)
    got = k4.flash_attention_bwd(*args, **kw)
    again = k4.flash_attention_bwd(*args, **kw)
    want = k4.flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2e-2 * float(w.float().abs().max()), (name, err)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-130m",
                                  "hymba-1.5b", "hubert-xlarge",
                                  "phi-3-vision-4.2b"])
def test_tp_families_packed_forward_on_card_near_unsharded(cuda, arch):
    """A smoke model, RTN-packed, every linear on K1 / K3: its
    `forward_logits` on a (1 x 2) mesh on cuda:0 (the MLA / SSD / hybrid
    mixers split, the frontends column-parallel) against the unsharded
    forward on the card, within 2 % of the largest logit (the shards'
    bf16 partial sums round at other places)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_dataset
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    cfg = configs.get_smoke_config(arch)
    m = Model(cfg)
    params, _ = quantize_params(m.init(torch.Generator(device="cuda")
                                       .manual_seed(0), device="cuda"))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in make_dataset(cfg, 2, 64).batch_at(0).items()
             if k != "labels"}
    mesh = make_host_mesh(1, 2, devices=["cuda:0"] * 2)
    grid = [shd.shard_params(params, rm, cfg)
            for rm in shd.replica_meshes(mesh)]
    # a MoE layer routes the sharded forward's tokens to the unsharded
    # forward's experts (a near tie would otherwise send one elsewhere)
    plain, routes = moe.route, []

    def record(probs, cfg_, cap):
        out = plain(probs, cfg_, cap)
        routes.append(out[0])
        return out

    def force(probs, cfg_, cap):
        idx = routes.pop(0)
        gates = torch.gather(probs, 1, idx)
        if cfg_.norm_topk_prob:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return (idx, gates, *moe.assign_slots(idx, cfg_.num_experts, cap))
    try:
        with execution_config(ExecutionConfig(offload_min_flops=0)), \
                torch.no_grad():
            moe.route = record
            want = m.forward_logits(params, batch)
            moe.route = force
            got = m.forward_logits(grid, batch, mesh=mesh)
    finally:
        moe.route = plain
    torch.cuda.synchronize()
    assert not routes
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 2e-2 * float(want.abs().max()), err


# ---------------------------------------------------------------- hd 32
# glm4-9b's smoke config: 4 q heads over 2 kv heads of 32 (G 2), S up to
# 128, chunk 16, no window; and one larger shape of the same head dim
HD32_K4 = [(2, 4, 2, 128, True, 0), (4, 4, 2, 512, True, 0),
           (1, 4, 2, 200, True, 48), (2, 4, 2, 77, False, 0),
           (1, 8, 1, 1, True, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,h,hkv,s,causal,window", HD32_K4)
def test_flash_attention_kernel_hd32(cuda, b, h, hkv, s, causal, window,
                                     dtype):
    """K4 at hd 32 (2 k-chunks, 4 output tiles a warp; 80-byte padded
    rows), on [B, S, H, hd] views as `attention()` passes them."""
    q, k, v = (torch.randn(b, s, n, 32, generator=cuda, device="cuda")
               .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
    before = k4.COUNTER.count
    out = k4.flash_attention(q, k, v, causal=causal, window=window)
    ref = k4.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k4.COUNTER.count == before + 1
    assert out.stride() == q.stride()
    _k4_check(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b,h,hkv,s,causal,window", HD32_K4)
def test_flash_attention_bwd_kernel_hd32(cuda, b, h, hkv, s, causal, window,
                                         dtype):
    """K4b at hd 32 (hd 64's tiles, half of each swizzled panel unused)
    against its plain version, at `test_flash_attention_bwd_kernel_
    matches_plain`'s bounds; two calls give the same bits."""
    args, kw = _k4b_run(cuda, b, h, hkv, s, 32, causal, window, dtype)
    before = k4.BWD_COUNTER.count
    got = k4.flash_attention_bwd(*args, **kw)
    again = k4.flash_attention_bwd(*args, **kw)
    want = k4.flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    assert k4.BWD_COUNTER.count == before + 2
    bound = {torch.bfloat16: 2e-2, torch.float16: 2.5e-3,
             torch.float32: 1e-4}[dtype]
    dv_scale = float(want[2].float().abs().max())
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), name
        scale = float(w.float().abs().max()) if s > 1 else dv_scale
        err = float((g.float() - w.float()).abs().max())
        assert err <= bound * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("nblk,ends", [(8, (17, 64, 100, 128)),
                                       (32, (17, 200, 300, 512))])
def test_paged_attention_kernel_hd32(cuda, nblk, ends, c):
    """K2 at glm4-9b's smoke heads (2 kv heads of 32, G 2) over slots of
    8 pages of 16 (its max_seq 128) and of 32 (512): the 2 chunks of a
    key row swizzled by c ^ (t / 4) % 2."""
    b, hkv, g, hd, page = 4, 2, 2, 32, 16
    npages = b * nblk + 1
    pools = _k2_pools(cuda, npages, page, hkv, hd)
    table = (torch.randperm(npages - 1, generator=cuda, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    base = torch.tensor([*ends[:3], ends[3] - c], dtype=torch.int32,
                        device="cuda")
    pos = (base[:, None] + torch.arange(c, dtype=torch.int32,
                                        device="cuda")[None]).contiguous()
    pos[0, c // 2 + 1:] = -1
    q = torch.randn(b, c, hkv, g, hd, generator=cuda, device="cuda")
    before = k2.COUNTER.count
    out = _k2_run(q, pools, table, pos)
    assert k2.COUNTER.count == before + 1
    assert out[3].abs().sum() > 0


def test_glm4_smoke_trains_and_serves_on_card(cuda):
    """glm4-9b's smoke config (hd 32) on the card: the train launcher's
    steps give finite losses with no recovery (K4 and K4b launched), and
    the engine serves greedy requests over int8 pages (K2 launched) whose
    streams are valid token ids."""
    from repro_torch.launch import train as train_launcher
    from repro_torch.configs import get_smoke_config
    before = (k4.COUNTER.count, k4.BWD_COUNTER.count, k2.COUNTER.count)
    out = train_launcher.main(["--arch", "glm4-9b", "--smoke", "--steps", "3",
                               "--batch", "2", "--seq", "64",
                               "--log-every", "100"])
    assert out["recoveries"] == 0 and out["steps"] == 3
    assert all(np.isfinite(out["losses"]))
    assert k4.COUNTER.count > before[0] and k4.BWD_COUNTER.count > before[1]
    m = Model(get_smoke_config("glm4-9b"))
    params, _ = quantize_params(m.init(cuda, device="cuda"))
    eng = GenerationEngine(m, params, num_slots=2, page_size=16, max_seq=128,
                           prefill_chunk=16, kv_quant="int8")
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(0, 512, n).astype(np.int32), 8)
            for n in (20, 45, 9)]
    res = eng.drain()
    assert k2.COUNTER.count > before[2]
    for r in rids:
        assert len(res[r]) == 8 and ((res[r] >= 0) & (res[r] < 512)).all()
