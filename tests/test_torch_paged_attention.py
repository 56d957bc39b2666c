"""Port parity: K2's plain version vs the JAX Pallas kernel (interpret).

Qwen2.5's grouping (G = 7, so C·G is odd), chunks of 1, 5 and 16 query
tokens, padding rows, stale page-table tails, and a tree-style case with
a non-trivial ancestor mask, logical positions and a sliding window.
Tolerance f32 rtol/atol 2e-5 (same math; online-softmax reassociation
only); rows that see nothing must be exactly 0 on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.models.attention import _kv_quantize
from repro_torch.kernels import paged_attention as k2

B, HKV, G, HD, P, NBLK, NPAGES = 3, 2, 7, 64, 8, 4, 16


def _case(c, tree, seed):
    rng = np.random.default_rng(seed)
    kf = rng.standard_normal((NPAGES, P, HKV, HD)).astype(np.float32)
    vf = rng.standard_normal((NPAGES, P, HKV, HD)).astype(np.float32)
    k, ks = (np.array(a) for a in _kv_quantize(jnp.asarray(kf * 2)))
    v, vs = (np.array(a) for a in _kv_quantize(jnp.asarray(vf)))
    q = rng.standard_normal((B, c, HKV, G, HD)).astype(np.float32)
    # every table entry points at a real page holding data, so a stale
    # tail (pages past the row's span) would leak if it were not masked
    table = rng.integers(1, NPAGES, (B, NBLK)).astype(np.int32)
    base = np.array([0 if tree else 3, NBLK * P - c - 2, 0], np.int32)
    pos = base[:, None] + np.arange(c, dtype=np.int32)[None]
    if c > 1:
        pos[1, c // 2 + 1:] = -1            # padded tail of a row
    pos[2] = -1                             # an all-padding row
    kw = {}
    if tree:
        # siblings share a depth: logical positions lag the slots
        rpos = np.where(pos >= 0, base[:, None] + np.arange(c) // 2, -1)
        amask = np.tril(rng.random((B, c, c)) < 0.6)
        amask[:, np.arange(c), np.arange(c)] = True
        amask &= (pos >= 0)[:, None, :]
        if c > 1:
            amask[0, 1, :] = False          # base 0: this query sees nothing
        kw = dict(rpos=rpos.astype(np.int32), amask=amask, window=6)
    return q, k, ks, v, vs, table, pos, kw


def _run_both(c, tree, seed):
    q, k, ks, v, vs, table, pos, kw = _case(c, tree, seed)
    jout = np.asarray(jpa.paged_attention_chunk(
        *(jnp.asarray(a) for a in (q, k, ks, v, vs, table, pos)),
        interpret=True, **{n: (jnp.asarray(a) if n != "window" else a)
                           for n, a in kw.items()}))
    tkw = {n: (torch.from_numpy(np.asarray(a)) if n != "window" else a)
           for n, a in kw.items()}
    tout = k2.paged_attention_chunk(
        *(torch.from_numpy(a) for a in (q, k, ks, v, vs, table, pos)), **tkw)
    return jout, tout.numpy(), pos, kw


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_plain_matches_jax_kernel(c, tree):
    jout, tout, pos, kw = _run_both(c, tree, seed=c + 10 * tree)
    assert tout.shape == (B, c, HKV, G, HD) and tout.dtype == np.float32
    np.testing.assert_allclose(tout, jout, rtol=2e-5, atol=2e-5)
    # padding queries, and (tree) a row whose ancestor mask is empty and
    # which has no committed keys, come out exactly 0 on both sides
    dead = pos < 0
    if tree and c > 1:
        dead[0, 1] = True
    assert dead.any()
    assert not tout[dead].any() and not jout[dead].any()
    assert np.abs(tout[~dead]).sum(axis=(-3, -2, -1)).min() > 0


@pytest.mark.parametrize("window", [0, 5])
def test_visibility_matches_jax(window):
    _, _, _, _, _, _, pos, kw = _case(5, True, seed=3)
    kw = dict(kw, window=window)
    jvis = np.asarray(jref.chunk_visibility_ref(
        jnp.asarray(pos), s_slot=NBLK * P, rpos=jnp.asarray(kw["rpos"]),
        amask=jnp.asarray(kw["amask"]), window=window))
    tvis = k2.chunk_visibility_ref(
        torch.from_numpy(pos), s_slot=NBLK * P,
        rpos=torch.from_numpy(kw["rpos"]),
        amask=torch.from_numpy(kw["amask"]), window=window)
    np.testing.assert_array_equal(tvis.numpy(), jvis)
    np.testing.assert_array_equal(
        k2.default_amask(torch.from_numpy(pos), window).numpy(),
        np.asarray(jpa.default_amask(jnp.asarray(pos), window)))


def test_decode_form_matches_jax():
    q, k, ks, v, vs, table, pos, _ = _case(1, False, seed=7)
    q1, p1 = q[:, 0], pos[:, 0]
    jout = np.asarray(jpa.paged_attention(
        *(jnp.asarray(a) for a in (q1, k, ks, v, vs, table, p1)),
        interpret=True))
    tout = k2.paged_attention(
        *(torch.from_numpy(a) for a in (q1, k, ks, v, vs, table, p1)))
    np.testing.assert_allclose(tout.numpy(), jout, rtol=2e-5, atol=2e-5)
