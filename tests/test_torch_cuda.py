"""Card-only tests: kernels K1, K2, K3 and K4 against their plain versions on
an NVIDIA GPU (Hopper, sm_90a). They skip where torch sees no CUDA device;
run them on the card with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_cuda.py`` (the suite's conftest
imports JAX, which this file does not need).

Tolerances: K1 sums exact bf16 × bf16 products in f32 in another order
than the plain version (rtol/atol 1e-4 of the output scale); K3 too, in
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
"""
import pytest
import torch

from repro_torch.core.packing import pack_linear
from repro_torch.core.quantize import QuantConfig, quantize_groupwise
from repro_torch.kernels import awq_matmul as k1
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import paged_attention as k2

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
    with pytest.raises(ValueError):
        k1.awq_matmul(torch.randn(2, 128, device="cuda"), p.qweight,
                      p.scales, p.zeros, 64)            # f32 x
    with pytest.raises(ValueError):
        k1.awq_matmul(torch.randn(2, 256, device="cuda").to(torch.bfloat16)
                      [:, ::2], p.qweight, p.scales, p.zeros, 64)


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
        k4.flash_attention(q[..., :32], k[..., :32], v[..., :32])  # hd 32
    with pytest.raises(ValueError):
        k4.flash_attention(q[:, :3], k, v)                   # H % Hkv


K4_MASKS = [(True, 0), (True, 128), (False, 0)]   # causal, window, bidir


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("s", [1, 15, 63, 64, 65, 1000])
def test_flash_attention_kernel_edges(cuda, s, dtype, hd):
    """S around the 64-row / 64-key tiles and a long ragged one, each
    type and head dim, Qwen2.5's 14 q / 2 kv heads, every mask."""
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
