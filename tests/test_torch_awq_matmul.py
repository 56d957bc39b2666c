"""Port parity: K1's plain version and `qlinear_apply` vs the JAX package.

The JAX Pallas kernel runs in interpret mode, as its own tests run it.
Tolerances: f32 compute rtol/atol 2e-5 (only the order of the sums
differs, `tests/test_kernels.py`), bf16 compute 2e-2. The plain
version's input scale and output rounding (K1's arguments since the
kernel applies them itself) must give, bit for bit, what `qlinear_apply`
composed around K1 before.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.core.calibration import LinearStats
from repro.core.quantize import QuantConfig as JQuantConfig
from repro.core.quantize import quantize_groupwise as jquantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import qlinear as tql
from repro_torch.core.packing import dequantize_packed
from repro_torch.kernels import awq_matmul as k1
from repro_torch.numerics import matmul_f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _packed(k, n, gs, seed):
    w = jax.random.normal(jax.random.PRNGKey(seed), (k, n)) * 0.1
    cfg = JQuantConfig(group_size=gs)
    q, s, z = jquantize(w, cfg)
    return jpack.pack_linear(q, s, z, None, None, cfg)


@pytest.mark.parametrize("k,n,gs", [(128, 136, 64), (256, 128, 128)])
@pytest.mark.parametrize("m", [1, 3, 7, 8, 12, 16, 64])
def test_plain_matches_jax_kernel_and_ref(m, k, n, gs):
    p = _packed(k, n, gs, seed=m)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    jk = np.asarray(jops.awq_matmul(jnp.asarray(x), p,
                                    compute_dtype=jnp.float32,
                                    interpret=True))
    jr = np.asarray(jref.awq_matmul_ref(jnp.asarray(x), p.qweight, p.scales,
                                        p.zeros, gs))
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    out = k1.awq_matmul(torch.from_numpy(x), tp.qweight, tp.scales, tp.zeros,
                        gs, compute_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), jk, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), jr, rtol=2e-5, atol=2e-5)


def test_plain_bf16_matches_jax():
    p = _packed(256, 256, 64, seed=9)
    x = np.random.default_rng(9).standard_normal((16, 256)).astype(np.float32)
    jr = np.asarray(jref.awq_matmul_ref(jnp.asarray(x), p.qweight, p.scales,
                                        p.zeros, 64,
                                        compute_dtype=jnp.bfloat16))
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    out = k1.awq_matmul(torch.from_numpy(x), tp.qweight, tp.scales, tp.zeros,
                        64)                  # default compute dtype: bf16
    np.testing.assert_allclose(out.numpy(), jr, rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def calibrated_linear():
    """A JAX linear quantized through AWQ calibration: non-unit
    input_scale, plus a bias."""
    k, n = 128, 256
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    rows = rng.standard_normal((64, k)).astype(np.float32)
    rows[:, :4] *= 20.0                      # salient input channels
    calib = {"lin": LinearStats(sum_abs=np.abs(rows).sum(0), count=64,
                                rows=rows)}
    qp, report = jpipe.quantize_params(
        {"lin": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}, calib)
    assert report.calibrated == ["lin"]
    p = qp["lin"]
    assert not np.allclose(np.asarray(p.input_scale), 1.0)
    return p


@pytest.mark.parametrize("m,path", [(4, "generic"), (16, "kernel")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_apply_matches_jax(calibrated_linear, m, path, dtype):
    """Both sides of the hybrid threshold (2·M·K·N vs 2^20 at K=128,
    N=256: M=4 stays generic, M=16 takes the kernel's wrapper)."""
    p = calibrated_linear
    x = np.random.default_rng(m).standard_normal((m, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jimpl = "ref" if path == "generic" else "kernel_interpret"
    jy = jql.qlinear_apply(p, jnp.asarray(x).astype(jdt), impl=jimpl,
                           cfg=jql.ExecutionConfig(compute_dtype=jdt))
    jy = np.asarray(jy.astype(jnp.float32))
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    before = tql.PathCounts(**vars(tql.COUNTS))
    ty = tql.qlinear_apply(tp, torch.from_numpy(x).to(tdt), impl="kernel",
                           cfg=tql.ExecutionConfig(compute_dtype=tdt))
    assert ty.dtype == tdt
    assert getattr(tql.COUNTS, path) == getattr(before, path) + 1
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=tol, atol=tol)


def test_cpu_tensors_take_plain_version_uncounted():
    """On CPU the wrapper takes the plain version for any dtype; launch
    counters move only for kernel launches."""
    p = _packed(128, 128, 64, seed=1)
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    n0 = k1.COUNTER.count
    k1.awq_matmul(torch.ones(3, 128, dtype=torch.float64), tp.qweight,
                  tp.scales, tp.zeros, 64, compute_dtype=torch.float32)
    assert k1.COUNTER.count == n0


def _scaled_linear(k, n, gs, seed, bias):
    """A JAX packed linear with a non-unit AWQ input scale (and a bias),
    with its port copy."""
    rng = np.random.default_rng(seed)
    cfg = JQuantConfig(group_size=gs)
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.1)
    q, s, z = jquantize(w, cfg)
    iscale = jnp.asarray(rng.uniform(0.5, 1.5, k).astype(np.float32))
    b = (jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1)
         if bias else None)
    p = jpack.pack_linear(q, s, z, iscale, b, cfg)
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    return p, tp


def _old_composition(x, tp, out_dtype):
    """What `qlinear_apply` formed around K1 before K1 took the input scale
    and the output type: x -> f32 * s -> bf16, the f32 product, -> out."""
    x2 = (x.to(torch.float32) * tp.input_scale[None, :]).to(torch.bfloat16)
    return matmul_f32(x2, dequantize_packed(tp, torch.bfloat16)).to(out_dtype)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_input_scale_and_out_dtype_match_old_composition(x_dtype,
                                                               out_dtype):
    _, tp = _scaled_linear(256, 136, 64, seed=3, bias=False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (13, 256)).astype(np.float32)).to(getattr(torch, x_dtype))
    odt = getattr(torch, out_dtype)
    want = _old_composition(x, tp, odt)
    args = (x, tp.qweight, tp.scales, tp.zeros, 64, torch.bfloat16)
    kw = dict(input_scale=tp.input_scale, out_dtype=odt)
    for fn in (k1.awq_matmul_ref, k1.awq_matmul):   # CPU: the same plain path
        got = fn(*args, **kw)
        assert got.dtype == odt and got.shape == (13, 136)
        assert torch.equal(got, want)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_input_scale_matches_jax_qlinear(x_dtype):
    """The same inputs through JAX's `qlinear_apply` (its plain path):
    the scale, the bf16 rounding and the output type as the port's."""
    p, tp = _scaled_linear(256, 136, 64, seed=4, bias=False)
    x = np.random.default_rng(4).standard_normal((9, 256)).astype(np.float32)
    jdt, tdt = getattr(jnp, x_dtype), getattr(torch, x_dtype)
    jy = jql.qlinear_apply(p, jnp.asarray(x).astype(jdt), impl="ref",
                           cfg=jql.ExecutionConfig(compute_dtype=jnp.bfloat16))
    ty = k1.awq_matmul_ref(torch.from_numpy(x).to(tdt), tp.qweight,
                           tp.scales, tp.zeros, 64, torch.bfloat16,
                           input_scale=tp.input_scale, out_dtype=tdt)
    assert ty.dtype == tdt
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_qlinear_apply_cpu_bits_unchanged(bias, impl):
    """`qlinear_apply` on the CPU gives the bits it gave when it scaled and
    rounded x itself around K1, on both routes (M 32 x K 256 x N 136
    clears the hybrid threshold, so ``kernel`` takes K1's wrapper)."""
    _, tp = _scaled_linear(256, 136, 64, seed=5, bias=bias)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, 256)).astype(np.float32)).to(torch.bfloat16)
    before = tql.PathCounts(**vars(tql.COUNTS))
    y = tql.qlinear_apply(tp, x, impl=impl)
    path = "kernel" if impl == "kernel" else "generic"
    assert getattr(tql.COUNTS, path) == getattr(before, path) + 1
    want = _old_composition(x.reshape(32, 256), tp, torch.bfloat16)
    if bias:
        want = want + tp.bias.to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 16, 136)
    assert torch.equal(y.reshape(32, 136), want)


@pytest.mark.parametrize("m,k,n,want", [
    (1, 896, 896, 7), (4, 4864, 896, 5), (16, 4864, 128, 5),
    (64, 896, 896, 1), (64, 4864, 896, 2), (64, 896, 128, 1),
    (64, 896, 4864, 7), (128, 4864, 896, 2), (256, 4864, 896, 4),
    (512, 4864, 896, 38), (1024, 896, 128, 1), (1024, 896, 896, 7),
    (1024, 4864, 896, 38), (1024, 896, 4864, 7)])
def test_span_block_plans(m, k, n, want):
    """K1's split of the spans over blocks at Qwen2.5's shapes: decode
    unsplit up to 8 spans, else in 8 groups (one round of a block's warps);
    prefill split only where its tiles fill less than half the SMs and
    the scratch is small."""
    sb = k1.span_block(m, k, n)
    assert sb == want
    nspan = -(-k // k1.SPAN)
    if sb < nspan:
        assert nspan * m * n * 4 <= k1.SPLIT_BYTES
