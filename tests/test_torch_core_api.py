"""`core`'s remaining API and `utils.tree.leaf_count` against the reference:
`set_execution_config` / `get_execution_config`, `quantization_mse`,
`fake_quantize_fast`, the package's re-exports.

Tolerances: the quantization codes are bit-identical to the reference's
(`tests/test_torch_quantize.py`), so `fake_quantize_fast` is held exactly
against the reference's eager `fake_quantize` on f32 weights, and against
its jitted `fake_quantize_fast` (whose fused dequant moves values by an
f32 ulp) and `quantization_mse` (another order of summation) at the
reference's f32 rule (`tests/test_kernels.py:40`: rtol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rcore
from repro.core import qlinear as rq
from repro.core import quantize as rquant
from repro.utils import tree as rtree

import repro_torch.core as core
from repro_torch.core import qlinear, quantize
from repro_torch.utils import tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def restore_exec():
    prev = qlinear._EXEC
    yield
    qlinear._EXEC = prev


def test_set_and_get_execution_config(restore_exec):
    """The setter replaces the ambient config's fields as the reference's
    does; the getter reads it; the context manager pins another for its
    block and the setter's config comes back after it."""
    assert qlinear.get_execution_config() == qlinear.ExecutionConfig()
    got = qlinear.set_execution_config(impl="ref", offload_min_flops=0)
    assert got is qlinear.get_execution_config()
    assert (got.impl, got.offload_min_flops, got.compute_dtype) == (
        "ref", 0, torch.bfloat16)
    again = qlinear.set_execution_config(impl="kernel")
    assert (again.impl, again.offload_min_flops) == ("kernel", 0)
    pinned = qlinear.ExecutionConfig(offload_min_flops=7)
    with qlinear.execution_config(pinned):
        assert qlinear.get_execution_config() is pinned
    assert qlinear.get_execution_config() is again
    # the reference's setter: the same fields, the same replace semantics
    prev = rq._EXEC
    try:
        ref = rq.set_execution_config(impl="ref", offload_min_flops=0)
        assert (ref.impl, ref.offload_min_flops) == (got.impl,
                                                     got.offload_min_flops)
        assert rq.get_execution_config() is ref
    finally:
        rq._EXEC = prev


def test_setter_reaches_qlinear_apply(restore_exec):
    """A call without ``cfg=`` reads the setter's config: with the
    threshold above a product's flops the kernel route takes the generic
    path (counted in `COUNTS`)."""
    from repro_torch.core.packing import pack_linear
    qc = quantize.QuantConfig(group_size=64)
    w = torch.randn(128, 64, generator=torch.Generator().manual_seed(0))
    p = pack_linear(*quantize.quantize_groupwise(w, qc), None, None, qc)
    x = torch.randn(2, 128, generator=torch.Generator().manual_seed(1))
    qlinear.set_execution_config(impl="kernel", offload_min_flops=2 ** 40)
    before = (qlinear.COUNTS.kernel, qlinear.COUNTS.generic)
    qlinear.qlinear_apply(p, x)
    assert (qlinear.COUNTS.kernel, qlinear.COUNTS.generic) == (
        before[0], before[1] + 1)
    qlinear.set_execution_config(offload_min_flops=0)
    qlinear.qlinear_apply(p, x)
    assert qlinear.COUNTS.kernel == before[0] + 1


@pytest.mark.parametrize("k,n,gs,sym", [(128, 64, 64, False),
                                        (256, 40, 32, True),
                                        (64, 8, 64, False)])
def test_fake_quantize_fast_and_mse_match_reference(k, n, gs, sym):
    rng = np.random.default_rng(k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.25                       # a constant column: scale 1
    rc = rquant.QuantConfig(group_size=gs, sym=sym)
    pc = quantize.QuantConfig(group_size=gs, sym=sym)
    got = quantize.fake_quantize_fast(torch.from_numpy(w), pc)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rquant.fake_quantize(jnp.asarray(w), rc)))
    # the reference's jitted form: XLA fuses the dequant's subtract and
    # multiply, which moves some values by an f32 ulp
    want = np.asarray(rquant.fake_quantize_fast(jnp.asarray(w), rc))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
    assert torch.equal(got, quantize.fake_quantize(torch.from_numpy(w), pc))
    want_mse = float(rquant.quantization_mse(jnp.asarray(w), rc))
    got_mse = quantize.quantization_mse(torch.from_numpy(w), pc)
    assert got_mse.dtype == torch.float32 and got_mse.dim() == 0
    np.testing.assert_allclose(float(got_mse), want_mse, rtol=2e-5)


def test_package_reexports_the_references_names():
    """`repro_torch.core` exports every name `repro.core` does, each the
    port's own object of its submodule."""
    names = [n for n in vars(rcore) if not n.startswith("_")
             and not isinstance(getattr(rcore, n), type(rcore))]
    assert len(names) == 15
    for name in names:
        assert hasattr(core, name), name
    assert core.set_execution_config is qlinear.set_execution_config
    assert core.QuantConfig is quantize.QuantConfig


def test_leaf_count_matches_reference():
    """`leaf_count` of a model's params, float and AWQ-packed (meta tensors
    too), equals the reference's of the same model."""
    from repro.configs import get_smoke_config as rsmoke
    from repro.core.pipeline import quantize_params as rqp
    from repro.models import build_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.pipeline import quantize_params
    from repro_torch.models.model import Model
    for arch in ("qwen25-05b", "qwen2-moe-a2.7b", "hymba-1.5b"):
        rparams = jax.eval_shape(lambda a=arch: build_model(rsmoke(a)).init(
            jax.random.PRNGKey(0)))
        m = Model(get_smoke_config(arch))
        params = m.init(torch.Generator().manual_seed(0), device="meta")
        assert tree.leaf_count(params) == rtree.leaf_count(rparams), arch
        rq_params = jax.eval_shape(lambda p=rparams: rqp(
            jax.tree.map(lambda t: jnp.zeros(t.shape, t.dtype), p))[0])
        assert tree.leaf_count(quantize_params(params)[0]) == \
            rtree.leaf_count(rq_params), arch
