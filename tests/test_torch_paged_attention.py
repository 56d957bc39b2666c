"""Port parity: K2's plain version vs the JAX Pallas kernel (interpret).

Qwen2.5's grouping (G = 7, so C·G is odd), chunks of 1, 5 and 16 query
tokens, padding rows, stale page-table tails, and a tree-style case with
a non-trivial ancestor mask, logical positions and a sliding window;
then the other dense models' groupings and head dims (hd 256 with and
without a window, G 8 over one kv head, G 16) against the JAX oracle.
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


def _torch_case(c, tree, seed):
    q, k, ks, v, vs, table, pos, kw = _case(c, tree, seed)
    args = tuple(torch.from_numpy(np.asarray(a))
                 for a in (q, k, ks, v, vs, table, pos))
    tkw = {n: (torch.from_numpy(np.asarray(a)) if n != "window" else a)
           for n, a in kw.items()}
    return args, tkw, pos, kw


def _merge_tol(whole):
    return 1e-6 * max(1.0, float(whole.abs().max()))


# splits of the slot's NBLK * P = 32 keys: the kernel's (one span of 128
# covers them), one span per page, one per key, uneven ones, and spans
# past every row's last visible key (they see nothing)
SPLITS = {
    "kernel": None,
    "pages": list(range(0, NBLK * P + 1, P)),
    "keys": list(range(NBLK * P + 1)),
    "uneven": [0, 3, 4, 17, 30, 32],
    "empty_tail": [0, 2, 9, 24, 27, 29, 31, 32],
}


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_split_merge_matches_whole_plain(c, tree, split):
    """The kernel's two passes in plain form: merging the partials of any
    split of the keys gives the whole plain version within 1e-6 of the
    output's scale, max(1, max|plain|) (f32: another order of sums and
    exps, a few ulps); rows that see nothing are exactly 0 both ways, and
    a span a row cannot see holds (NEG_INF, 0, 0)."""
    args, tkw, pos, kw = _torch_case(c, tree, seed=20 + c + 10 * tree)
    whole = k2.paged_attention_chunk_ref(*args, **tkw)
    m, l, acc = k2.paged_attention_partials_ref(*args, bounds=SPLITS[split],
                                                **tkw)
    n = 1 if split == "kernel" else len(SPLITS[split]) - 1
    assert m.shape == (n, B, c, HKV, G) and acc.shape == (n, B, c, HKV, G,
                                                          HD)
    merged = k2.paged_attention_merge_ref(m, l, acc)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=0,
                               atol=_merge_tol(whole))
    dead = torch.from_numpy(pos < 0)
    if tree and c > 1:
        dead[0, 1] = True
    assert not merged[dead].any() and not whole[dead].any()
    unseen = l == 0
    assert unseen.any()
    assert bool((m[unseen] == k2.NEG_INF).all())
    assert not acc[unseen].any()


@pytest.mark.parametrize("window", [0, 128])
def test_kernel_spans_over_a_long_slot(window):
    """A 600-key slot split the kernel's way (128-key spans, the last
    one short), decode and chunk rows, with and without a window: the
    merged partials equal the whole plain version within 1e-6 of the
    output's scale."""
    rng = np.random.default_rng(5 + window)
    b, hkv, g, hd, page, nblk = 2, 2, 7, 64, 8, 75
    npages = b * nblk + 1
    k, ks, v, vs = (
        torch.from_numpy(rng.integers(-127, 128, (npages, page, hkv, hd))
                         .astype(np.int8)),
        torch.from_numpy((rng.random((npages, page, hkv)) / 20)
                         .astype(np.float32)),
        torch.from_numpy(rng.integers(-127, 128, (npages, page, hkv, hd))
                         .astype(np.int8)),
        torch.from_numpy((rng.random((npages, page, hkv)) / 20)
                         .astype(np.float32)))
    table = torch.from_numpy((rng.permutation(npages - 1)[:b * nblk] + 1)
                             .astype(np.int32).reshape(b, nblk))
    for c, base in ((1, [599, 255]), (16, [0, 584])):
        pos = torch.tensor(base, dtype=torch.int32)[:, None] + torch.arange(
            c, dtype=torch.int32)[None]
        q = torch.from_numpy(rng.standard_normal((b, c, hkv, g, hd))
                             .astype(np.float32))
        args = (q, k, ks, v, vs, table, pos)
        assert k2.kernel_bounds(nblk * page) == [0, 128, 256, 384, 512, 600]
        m, l, acc = k2.paged_attention_partials_ref(*args, window=window)
        assert m.shape[0] == 5
        whole = k2.paged_attention_chunk_ref(*args, window=window)
        np.testing.assert_allclose(
            k2.paged_attention_merge_ref(m, l, acc).numpy(), whole.numpy(),
            rtol=0, atol=_merge_tol(whole))


# the other dense models' (Hkv, G, hd, window): gemma3's global and windowed
# layers, gemma-2b (MQA), glm4, smollm; phi-3-vision (MHA at hd 96: 32 kv
# heads, G 1), and hd 96 under a window
NEW_SHAPES = [(4, 2, 256, 0), (4, 2, 256, 6), (1, 8, 256, 0), (2, 16, 128, 0),
              (5, 3, 64, 0), (32, 1, 96, 0), (4, 1, 96, 6)]


@pytest.mark.parametrize("hkv,g,hd,window", NEW_SHAPES)
@pytest.mark.parametrize("c", [1, 5])
def test_plain_matches_jax_oracle_at_new_shapes(c, hkv, g, hd, window):
    rng = np.random.default_rng(c + hd + g)
    shape = (NPAGES, P, hkv, hd)
    k, ks = (np.array(a) for a in _kv_quantize(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * 2)))
    v, vs = (np.array(a) for a in _kv_quantize(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32))))
    q = rng.standard_normal((B, c, hkv, g, hd)).astype(np.float32)
    table = rng.integers(1, NPAGES, (B, NBLK)).astype(np.int32)
    base = np.array([3, NBLK * P - c - 2, 0], np.int32)
    pos = base[:, None] + np.arange(c, dtype=np.int32)[None]
    pos[2] = -1
    jout = np.asarray(jref.paged_attention_chunk_ref(
        *(jnp.asarray(a) for a in (q, k, ks, v, vs, table, pos)),
        window=window))
    tout = k2.paged_attention_chunk(
        *(torch.from_numpy(a) for a in (q, k, ks, v, vs, table, pos)),
        window=window).numpy()
    np.testing.assert_allclose(tout, jout, rtol=2e-5, atol=2e-5)
    assert not tout[2].any() and not jout[2].any()
