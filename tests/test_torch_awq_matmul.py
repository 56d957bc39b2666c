"""Port parity: K1's plain version and `qlinear_apply` vs the JAX package.

The JAX Pallas kernel runs in interpret mode, as its own tests run it.
Tolerances: f32 compute rtol/atol 2e-5 (only the order of the sums
differs, `tests/test_kernels.py`), bf16 compute 2e-2.
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
from repro_torch.kernels import awq_matmul as k1


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
