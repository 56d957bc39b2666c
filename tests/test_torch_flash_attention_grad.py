"""Port parity: K4b's plain version (`flash_attention_bwd_ref`) and the
autograd Function around K4 / K4b, against ``jax.vjp`` of the reference's
oracle `ref.flash_attention_ref` (the function XLA differentiates when the
reference trains; it has no hand-written backward).

Inputs and the output's cotangent are made with numpy from a seed and fed
to both. Tolerance: rtol/atol 2e-5, the reference's own f32 kernel
tolerance (`tests/test_kernels.py`): the same math in f32, sums taken in
another order. The Function's CPU gradients are held against PyTorch
autograd through `flash_attention_ref` at the same tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
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

CASES = [
    # b, h, hkv, s, hd, causal, window
    (1, 2, 2, 64, 64, True, 0),       # G 1
    (2, 4, 2, 48, 64, True, 0),       # G 2
    (1, 14, 2, 40, 64, True, 0),      # G 7 (Qwen2.5's 14 / 2)
    (1, 7, 1, 37, 128, True, 16),     # G 7, hd 128, windowed, ragged S
    (1, 4, 2, 33, 128, True, 8),      # windowed, ragged S
    (1, 2, 1, 29, 64, False, 0),      # bidirectional, ragged S
    (1, 2, 2, 1, 64, True, 0),        # one token
]


def _inputs(seed, b, h, hkv, s, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, hd), (b, hkv, s, hd),
                               (b, hkv, s, hd), (b, h, s, hd)))


@functools.partial(jax.jit, static_argnums=(4, 5))
def _vjp(q, k, v, do, causal, window):
    out, vjp = jax.vjp(lambda *a: jref.flash_attention_ref(
        *a, causal=causal, window=window), q, k, v)
    return out, vjp(do)


def _jax_grads(q, k, v, do, causal, window):
    out, grads = _vjp(*map(jnp.asarray, (q, k, v, do)), causal, window)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window", CASES)
def test_bwd_ref_matches_jax_grad_of_oracle(b, h, hkv, s, hd, causal,
                                            window):
    q, k, v, do = _inputs(s, b, h, hkv, s, hd)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = k4.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                          window=window)
    got = k4.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                     causal=causal, window=window)
    want_out, want = _jax_grads(q, k, v, do, causal, window)
    np.testing.assert_allclose(out.numpy(), want_out, **F32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **F32, err_msg=name)


@pytest.mark.parametrize("b,h,hkv,s,hd,causal,window", CASES[1:5])
def test_function_cpu_grads_equal_autograd_of_plain(b, h, hkv, s, hd, causal,
                                                    window):
    q, k, v, do = map(torch.from_numpy, _inputs(7, b, h, hkv, s, hd))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = k4.flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(plain, leaves, do)
    leaves2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = k4.flash_attention(*leaves2, causal=causal, window=window)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFn")
    got = torch.autograd.grad(out, leaves2, do)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32)


def test_lse_is_the_rows_logsumexp():
    """lse = log sum_j exp(s_ij) over the visible keys, in f32 [B, H, S]."""
    q, k, v, _ = map(torch.from_numpy, _inputs(3, 1, 4, 2, 20, 64))
    _, lse = k4.flash_attention_lse_ref(q, k, v, causal=True, window=6)
    assert lse.shape == (1, 4, 20) and lse.dtype == torch.float32
    sc = torch.einsum("bhqd,bhsd->bhqs", q.double(),
                      k.double().repeat_interleave(2, dim=1)) * 64 ** -0.5
    vis = k4.visibility(20, causal=True, window=6)
    want = torch.logsumexp(sc.masked_fill(~vis, -torch.inf), dim=-1)
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-6)


def test_no_grad_call_takes_the_bare_forward():
    """Serving's calls (no grad) build no autograd node; a call whose
    inputs need no grad neither."""
    q, k, v, _ = map(torch.from_numpy, _inputs(4, 1, 2, 1, 8, 64))
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert k4.flash_attention(qg, k, v).grad_fn is None
    assert k4.flash_attention(q, k, v).grad_fn is None
    assert k4.flash_attention(qg, k, v).grad_fn is not None
