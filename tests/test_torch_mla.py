"""Port parity: Multi-head Latent Attention (`models/mla.py`) against the
reference's, on deepseek-v2-lite's smoke config (2 heads, q·k width 96 =
64 nope + 32 rope, v width 64, latent rank 64).

The reference's params (`mla.mla_init` with a `jax.random` key) are
carried over by `bridge.tree_to_torch`; inputs are made with numpy from a
seed. Everything runs in f32 on both sides, so the tolerance is the
reference's f32 kernel tolerance (rtol / atol 2e-5,
`tests/test_kernels.py:40`): the two frameworks sum the same products in
another order. Held: the explicit prefill form (one block of queries,
and ``attn_chunk`` blocks past it), the latent cache a prefill fills,
absorbed decode steps over that cache with float and with packed
``kv_up``, and the W_UK / W_UV column blocks sliced from the packed
integers, equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import pipeline as jpipe
from repro.models import mla as jmla
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear
from repro_torch.models import mla as tmla

F32 = dict(rtol=2e-5, atol=2e-5)
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def mla():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               activation_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               activation_dtype="float32")
    jp = jmla.mla_init(jax.random.PRNGKey(7), jcfg)
    return jcfg, tcfg, jp, bridge.tree_to_torch(_np(jp), device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


@pytest.mark.parametrize("s", [20, 64], ids=["one_block", "attn_chunks"])
def test_prefill_attention_matches_reference(mla, s):
    """The explicit form over [2, S, D]: S 20 in one block of queries, S 64
    in blocks of ``attn_chunk`` (32)."""
    jcfg, tcfg, jp, tp = mla
    x, pos = _x((2, s, tcfg.d_model), s), _pos(2, s)
    jy = jmla.mla_attention(jp, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos))
    ty = tmla.mla_attention(tp, torch.from_numpy(x), tcfg,
                            positions=torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)


@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_cache_fill_and_absorbed_decode_match_reference(mla, packed):
    """A prefill of 12 tokens fills the latent cache (c_kv after kv_norm,
    k_pe after rope); then 4 absorbed decode steps (rows at positions 12 …
    15 and, in row 1, from 5: rows advance independently), the cache's
    latents and each step's output against the reference's."""
    jcfg, tcfg, jp, tp = mla
    if packed:
        jp, _ = jpipe.quantize_params(jp)
        tp, rep = tpipe.quantize_params(tp)
        assert isinstance(tp["kv_up"], PackedLinear) and rep.quantized
    b, s, smax = 2, 12, 24
    x, pos = _x((b, s, tcfg.d_model), 1), _pos(b, s)
    jc = jmla.init_mla_cache(jcfg, b, smax, dtype=jnp.float32)
    tc = tmla.init_mla_cache(tcfg, b, smax, dtype=torch.float32)
    c, kpe = jmla._project_latent(jp, jnp.asarray(x), jcfg,
                                  jnp.asarray(pos), None)
    jc = jmla.fill_mla_cache_from_prefill(jc, c, kpe)
    c, kpe = tmla._project_latent(tp, torch.from_numpy(x), tcfg,
                                  torch.from_numpy(pos), None)
    tc = tmla.fill_mla_cache_from_prefill(tc, c, kpe)
    for k in ("ckv", "kpe"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)
    step = np.array([s, 5], np.int32)
    for i in range(4):
        xd = _x((b, tcfg.d_model), 10 + i)
        jy, jc = jmla.mla_decode(jp, jc, jnp.asarray(xd), jcfg,
                                 pos=jnp.asarray(step))
        ty, tc = tmla.mla_decode(tp, tc, torch.from_numpy(xd), tcfg,
                                 pos=torch.from_numpy(step))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
        step = step + 1
    for k in ("ckv", "kpe"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)


def test_packed_kv_up_column_blocks_equal_reference(mla):
    """W_UK's and W_UV's column blocks of the packed ``kv_up`` (words,
    scales and zeros sliced per head, never dequantized) equal the
    reference's slices."""
    jcfg, tcfg, jp, tp = mla
    jq, _ = jpipe.quantize_params(jp)
    tq, _ = tpipe.quantize_params(tp)
    h, nope, vdim = tcfg.num_heads, tcfg.qk_nope_head_dim, tcfg.v_head_dim
    for sl in (slice(None, nope), slice(nope, None)):
        jb = jmla._packed_col_block(jq["kv_up"], h, nope + vdim, sl)
        tb = tmla._packed_col_block(tq["kv_up"], h, nope + vdim, sl)
        for f in ("qweight", "scales", "zeros", "input_scale"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))
        assert tb.group_size == jb.group_size and tb.bias is None
