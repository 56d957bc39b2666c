"""Card-only tests: kernels K1, K2 and K4 against their plain versions on
an NVIDIA GPU (Hopper, sm_90a). They skip where torch sees no CUDA device;
run them on the card with ``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_cuda.py`` (the suite's conftest
imports JAX, which this file does not need).

Tolerances: K1 sums exact bf16 × bf16 products in f32 in another order
than the plain version (rtol/atol 1e-4 of the output scale); K2 runs the
same f32 math with an online softmax (atol 1e-5). K4 runs f32 math with
an online softmax too and rounds once to the input type, so two results
a few f32 ulps apart may round to neighbouring values: atol 1e-5 plus
one unit of the type's precision relative to the value
(`torch.finfo(dtype).eps`).
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


@pytest.mark.parametrize("c", [1, 5, 16])
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
