"""Port parity: K4's plain version vs the JAX Pallas kernel (interpret)
and the JAX oracle `ref.flash_attention_ref`.

The cases of `tests/test_flash_attention.py` (GQA, MQA, bidirectional,
sliding window, odd head counts) at the kernel's tile multiples, then
ragged S against the JAX oracle only (interpret mode needs S to be a
multiple of its blocks). Inputs are made with numpy from a seed and fed
to both. Tolerances: f32 rtol/atol 2e-5 (the reference's f32 kernel
tolerance; same math, another order of sums); bf16 2e-2 (the reference's
bf16 tolerance: both sides round an f32 result once to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.bridge import to_tensor
from repro_torch.kernels import flash_attention as k4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

CASES = [
    # b, h, hkv, s, hd, causal, window, bq, bk
    (1, 2, 2, 256, 64, True, 0, 128, 128),
    (2, 4, 2, 256, 64, True, 0, 128, 128),      # GQA g=2
    (1, 8, 1, 128, 128, True, 0, 64, 64),       # MQA
    (1, 2, 2, 256, 64, False, 0, 128, 128),     # bidirectional (encoder)
    (1, 2, 2, 512, 64, True, 128, 128, 128),    # sliding window
    (2, 3, 1, 384, 64, True, 0, 128, 128),      # odd head count, g=3
    # the other dense models' shapes: gemma3 (8 / 4 heads, hd 256, and its
    # windowed layers), gemma-2b (MQA, g = 8, hd 256), glm4 (g = 16, hd 128)
    (1, 8, 4, 128, 256, True, 0, 64, 64),
    (1, 8, 4, 192, 256, True, 64, 64, 64),
    (1, 8, 1, 128, 256, True, 0, 64, 64),
    (1, 16, 1, 128, 128, True, 0, 64, 64),
    # hubert-xlarge (MHA, hd 80, bidirectional) and phi-3-vision (MHA,
    # hd 96, causal), each also with the other mask
    (1, 4, 4, 128, 80, False, 0, 64, 64),
    (2, 2, 2, 192, 80, True, 0, 64, 64),
    (1, 4, 4, 128, 96, True, 0, 64, 64),
    (2, 2, 2, 192, 96, False, 0, 64, 64),
]


def _inputs(seed, b, h, hkv, s, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((b, h, s, hd), (b, hkv, s, hd),
                               (b, hkv, s, hd)))


@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window,bq,bk", CASES)
def test_plain_matches_jax_kernel_and_oracle(b, h, hkv, s, hd, causal,
                                             window, bq, bk):
    q, k, v = _inputs(0, b, h, hkv, s, hd)
    got = k4.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jflash(jq, jk, jv, causal=causal, window=window, block_q=bq,
                  block_k=bk, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


def test_plain_bf16_matches_jax():
    """bf16 in, bf16 out, f32 math on both sides."""
    q, k, v = _inputs(1, 1, 2, 2, 256, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (to_tensor(np.asarray(a), "cpu") for a in (jq, jk, jv))
    got = k4.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    kern = jflash(jq, jk, jv, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv)
    for ref in (kern, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **BF16)


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (50, True, 0), (129, True, 33), (300, False, 0),
    (77, False, 16), (200, True, 128)])
def test_plain_ragged_s_matches_jax_oracle(s, causal, window):
    """S that is not a tile multiple (the kernel masks the tail)."""
    q, k, v = _inputs(2, 2, 14, 2, s, 64)
    got = k4.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window).numpy()
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


def test_plain_takes_strided_views_and_counts_no_launch():
    """[B, S, H, hd] projections passed as transpose(1, 2) views give what
    contiguous inputs give; the CPU path launches nothing."""
    q, k, v = _inputs(3, 2, 6, 3, 40, 64)
    before = k4.COUNTER.count
    views = [torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = k4.flash_attention(*views, scale=0.1)
    ref = k4.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.1)
    assert k4.COUNTER.count == before
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 8)])
def test_plain_matches_masked_softmax_by_hand(causal, window):
    """Every row of square attention sees its own key, so no row is
    empty; each equals a masked softmax written out by hand in f64."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 4, 2, 70, 64))
    out = k4.flash_attention(q, k, v, causal=causal, window=window)
    vis = k4.visibility(70, causal=causal, window=window)
    assert bool(vis.diagonal().all())
    sc = torch.einsum("bhqd,bhsd->bhqs", q.double(),
                      k.double().repeat_interleave(2, dim=1)) * 64 ** -0.5
    p = torch.softmax(sc.masked_fill(~vis, float("-inf")), dim=-1)
    ref = torch.einsum("bhqs,bhsd->bhqd", p,
                       v.double().repeat_interleave(2, dim=1))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32)


def test_visibility_is_the_reference_mask():
    for s, causal, window in ((9, True, 0), (9, True, 3), (9, False, 4),
                              (9, False, 0)):
        qpos = np.arange(s)[:, None]
        kpos = np.arange(s)[None, :]
        want = np.ones((s, s), bool)
        if causal:
            want &= kpos <= qpos
        if window:
            want &= kpos > qpos - window
        got = k4.visibility(s, causal=causal, window=window).numpy()
        np.testing.assert_array_equal(got, want)
