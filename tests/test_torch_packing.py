"""Port parity: int4 packing and group quantization vs the JAX package.

Packed words, unpacked codes, dequantized weights and quantized codes
must equal the reference bit for bit; scales and zeros are compared at
f32 rtol 2e-5 (they equal in practice; the bound allows for a different
division routine).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core import quantize as jquant
from repro_torch.core import packing as tpack
from repro_torch.core import quantize as tquant


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("k,n", [(64, 8), (128, 136), (896, 128)])
def test_pack_unpack_bit_exact(k, n):
    rng = np.random.default_rng(k + n)
    q = rng.integers(0, 16, (k, n)).astype(np.int32)
    q[:8, :4] = 15                      # all-ones nibbles: negative int32 words
    jw = np.asarray(jpack.pack_int4(jnp.asarray(q)))
    tw = tpack.pack_int4(torch.from_numpy(q))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert (jw < 0).any()
    np.testing.assert_array_equal(tpack.unpack_int4(tw).numpy(), q)
    np.testing.assert_array_equal(
        tpack.unpack_int4(tw).numpy(),
        np.asarray(jpack.unpack_int4(jnp.asarray(jw))))


@pytest.mark.parametrize("gs,sym", [(64, False), (128, False), (64, True)])
def test_quantize_and_dequantize_match_jax(gs, sym):
    rng = np.random.default_rng(gs)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[:, 3] = 0.25                      # constant columns: scale falls back to 1
    cfg_j = jquant.QuantConfig(group_size=gs, sym=sym)
    cfg_t = tquant.QuantConfig(group_size=gs, sym=sym)
    jq, js, jz = (np.asarray(a) for a in
                  jquant.quantize_groupwise(jnp.asarray(w), cfg_j))
    tq, ts, tz = tquant.quantize_groupwise(torch.from_numpy(w), cfg_t)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_allclose(ts.numpy(), js, rtol=2e-5)
    np.testing.assert_array_equal(tz.numpy(), jz)

    jp = jpack.pack_linear(jnp.asarray(jq), jnp.asarray(js), jnp.asarray(jz),
                           None, None, cfg_j)
    tp = tpack.pack_linear(tq, ts, tz, None, None, cfg_t)
    np.testing.assert_array_equal(tp.qweight.numpy(), np.asarray(jp.qweight))
    np.testing.assert_array_equal(tp.zeros.numpy(), np.asarray(jp.zeros))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jd = np.asarray(jpack.dequantize_packed(jp, dt_j).astype(jnp.float32))
        td = tpack.dequantize_packed(tp, dt_t).float().numpy()
        np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(
        tquant.dequantize_groupwise(tq, ts, tz, cfg_t).numpy(),
        np.asarray(jquant.dequantize_groupwise(jnp.asarray(jq),
                                               jnp.asarray(js),
                                               jnp.asarray(jz), cfg_j)))


def test_packed_nbytes_match_jax():
    for k, n, gs in ((896, 896, 64), (4864, 896, 64), (896, 128, 128)):
        assert tpack.packed_linear_nbytes(k, n, gs) == \
            jpack.packed_linear_nbytes(k, n, gs)


@pytest.mark.parametrize("k,n,gs", [(128, 16, 64), (256, 24, 128),
                                    (896, 128, 64), (384, 136, 128)])
def test_awq_macro_bytes_match_jax_and_round_trip(k, n, gs):
    """The port's vectorized AWQ_MACRO serializer writes the reference
    loop's bytes (codes 0 and 15 at the nibble edges, negative and tiny
    fp16 scales), its parser inverts both, and the length is
    `packed_linear_nbytes`."""
    rng = np.random.default_rng(k + n + gs)
    q = rng.integers(0, 16, (k, n)).astype(np.int32)
    q[:2, :8] = 15
    q[2:4, :8] = 0
    s = (rng.standard_normal((k // gs, n)) * 0.01).astype(np.float32)
    s[0, :3] = (-0.5, 6e-8, 65504.0)
    z = rng.integers(0, 16, (k // gs, n)).astype(np.int8)
    ref = jpack.awq_macro_bytes(q, s, z, gs)
    got = tpack.awq_macro_bytes(q, s, z, gs)
    assert got == ref
    assert len(got) == tpack.packed_linear_nbytes(k, n, gs)
    pq, ps, pz = tpack.parse_awq_macro_bytes(got, k, n, gs)
    jq, js, jz = jpack.parse_awq_macro_bytes(ref, k, n, gs)
    np.testing.assert_array_equal(pq, q)
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(ps.view(np.uint16), js.view(np.uint16))
    np.testing.assert_array_equal(ps, s.astype(np.float16))
    np.testing.assert_array_equal(pz, z.astype(np.uint8))
    np.testing.assert_array_equal(pz, jz)
    with pytest.raises(ValueError):
        tpack.parse_awq_macro_bytes(got[:-1], k, n, gs)


def test_packed_linear_macro_bytes_match_jax():
    """A `PackedLinear`'s bytes: its words unpacked with the port's own
    `unpack_int4`, equal to the reference serializer on the reference's
    packed linear from the same codes."""
    cfg_j, cfg_t = jquant.QuantConfig(group_size=64), \
        tquant.QuantConfig(group_size=64)
    w = (np.random.default_rng(3).standard_normal((256, 48)) * 0.05
         ).astype(np.float32)
    jq, js, jz = (np.asarray(a) for a in
                  jquant.quantize_groupwise(jnp.asarray(w), cfg_j))
    tq, ts, tz = tquant.quantize_groupwise(torch.from_numpy(w), cfg_t)
    tp = tpack.pack_linear(tq, ts, tz, None, None, cfg_t)
    assert tpack.packed_linear_macro_bytes(tp) == \
        jpack.awq_macro_bytes(jq, js, jz, 64)
