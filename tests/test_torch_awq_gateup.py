"""Port parity: K3's plain version and the fused GLU front vs the JAX package.

`awq_gateup_ref` (and `awq_gateup` on CPU tensors) against the JAX
oracle `ref.awq_gateup_ref` and the Pallas kernel in interpret mode, as
`tests/test_kernels.py` runs it, at the M values the scheduler emits
(`width_family(16, 4)` × 4 slots). Tolerances as the reference's kernel
tests state them: f32 compute rtol/atol 2e-5 (only the order of the sums
differs), bf16 compute 2e-2.

The model path: `blocks._mlp_apply` takes K3 (`qgateup_apply`) when gate
and up are packed alike; on the CPU that must be bit-identical to the
two-`qlinear_apply` path it replaces, for RTN weights and for AWQ
weights whose gate and up carry different input scales, and within bf16
tolerance of the JAX package's `_mlp_apply` on the same weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen25_05b as jcfgs
from repro.core import packing as jpack
from repro.core.quantize import QuantConfig as JQuantConfig
from repro.core.quantize import quantize_groupwise as jquantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.serving.scheduler import width_family
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core import qlinear as tql
from repro_torch.core.calibration import CalibrationCapture
from repro_torch.core.packing import PackedLinear
from repro_torch.core.pipeline import quantize_params
from repro_torch.data.pipeline import make_dataset
from repro_torch.kernels import awq_matmul as k1
from repro_torch.models import blocks
from repro_torch.models.layers import activation
from repro_torch.models.model import Model


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


def _packed(k, n, gs, seed):
    w = jax.random.normal(jax.random.PRNGKey(seed), (k, n)) * 0.1
    cfg = JQuantConfig(group_size=gs)
    return jpack.pack_linear(*jquantize(w, cfg), None, None, cfg)


def _to_port(p):
    return bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                                device="cpu")


def _port_gateup(x, g, u, gs, dtype, **kw):
    return k1.awq_gateup(torch.from_numpy(x), g.qweight, g.scales, g.zeros,
                         u.qweight, u.scales, u.zeros, gs,
                         compute_dtype=dtype, **kw)


@pytest.mark.parametrize("m", [c * 4 for c in width_family(16, 4)])
def test_plain_matches_jax_kernel_and_ref(m):
    k, n, gs = 256, 384, 64
    jg, ju = _packed(k, n, gs, seed=6), _packed(k, n, gs, seed=7)
    x = np.random.default_rng(200 + m).standard_normal((m, k)).astype(
        np.float32)
    jr = np.asarray(jref.awq_gateup_ref(
        jnp.asarray(x), jg.qweight, jg.scales, jg.zeros, ju.qweight,
        ju.scales, ju.zeros, gs))
    jk = np.asarray(jops.awq_gateup(jnp.asarray(x), jg, ju,
                                    compute_dtype=jnp.float32,
                                    interpret=True))
    out = _port_gateup(x, _to_port(jg), _to_port(ju), gs, torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), jr, **F32)
    np.testing.assert_allclose(out.numpy(), jk, **F32)
    # the named plain version is what the CPU wrapper ran
    ref = k1.awq_gateup_ref(torch.from_numpy(x), *(
        t for p in (_to_port(jg), _to_port(ju))
        for t in (p.qweight, p.scales, p.zeros)), gs)
    assert torch.equal(out, ref)


def test_plain_bf16_matches_jax():
    k, n, gs = 448, 136, 64
    jg, ju = _packed(k, n, gs, seed=1), _packed(k, n, gs, seed=2)
    x = np.random.default_rng(3).standard_normal((16, k)).astype(np.float32)
    jr = np.asarray(jref.awq_gateup_ref(
        jnp.asarray(x), jg.qweight, jg.scales, jg.zeros, ju.qweight,
        ju.scales, ju.zeros, gs, compute_dtype=jnp.bfloat16))
    out = _port_gateup(x, _to_port(jg), _to_port(ju), gs, torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), jr, **BF16)


def test_input_scales_and_output_rounding_are_the_two_linears():
    """With (gate, up) input scales and a bf16 output the plain version
    is exactly ``silu(qlinear(gate, x)) * qlinear(up, x)``; without them
    and with an f32 output, exactly the JAX function's f32 formula."""
    k, n, gs = 256, 128, 128
    rng = np.random.default_rng(4)
    g, u = _to_port(_packed(k, n, gs, seed=8)), _to_port(_packed(k, n, gs,
                                                                  seed=9))
    g.input_scale = torch.from_numpy(rng.uniform(0.5, 2, k).astype(np.float32))
    u.input_scale = torch.from_numpy(rng.uniform(0.5, 2, k).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(
        np.float32)).to(torch.bfloat16)
    two = activation("silu", tql.qlinear_apply(g, x, impl="ref")) \
        * tql.qlinear_apply(u, x, impl="ref")
    fused = k1.awq_gateup(x, g.qweight, g.scales, g.zeros, u.qweight,
                          u.scales, u.zeros, gs,
                          input_scales=(g.input_scale, u.input_scale),
                          out_dtype=torch.bfloat16)
    assert fused.dtype == torch.bfloat16 and torch.equal(fused, two)
    gf = k1.awq_matmul_ref(x, g.qweight, g.scales, g.zeros, gs,
                           torch.bfloat16)
    uf = k1.awq_matmul_ref(x, u.qweight, u.scales, u.zeros, gs,
                           torch.bfloat16)
    f32 = k1.awq_gateup(x, g.qweight, g.scales, g.zeros, u.qweight, u.scales,
                        u.zeros, gs)
    assert f32.dtype == torch.float32
    assert torch.equal(f32, torch.nn.functional.silu(gf) * uf)


# ----------------------------------------------------------- the model path

def _smoke(adt="bfloat16"):
    return dataclasses.replace(tcfgs.smoke_config(), activation_dtype=adt)


@pytest.fixture(scope="module")
def packed_models():
    """Smoke-model params RTN-packed, and AWQ-packed from the model's own
    calibration forward (gate and up then carry different input scales)."""
    cfg = _smoke()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             make_dataset(cfg, 2, 64, seed=123).batch_at(0).items()}
    with CalibrationCapture() as cap, torch.no_grad():
        m.loss(p, batch)
    return cfg, {"rtn": quantize_params(p)[0],
                 "awq": quantize_params(p, cap.stats)[0]}


@pytest.mark.parametrize("adt", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["rtn", "awq"])
def test_fused_mlp_bit_identical_to_two_linears(packed_models, kind, adt):
    cfg, params = packed_models
    cfg = _smoke(adt)
    lk = cfg.layer_kinds()[0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)).to(getattr(torch, adt))
    for layer in params[kind]["segments"]["seg_0"]:
        mp = layer["mlp"]
        assert blocks._fused_gateup(mp, cfg)
        if kind == "awq":
            assert not torch.equal(mp["gate"].input_scale,
                                   mp["up"].input_scale)
        before = (tql.COUNTS.kernel, tql.COUNTS.generic)
        fused = blocks._mlp_apply(layer, x, cfg, lk)
        assert tql.COUNTS.kernel + tql.COUNTS.generic == sum(before) + 2
        h = activation("silu", tql.qlinear_apply(mp["gate"], x)) \
            * tql.qlinear_apply(mp["up"], x)
        two = tql.qlinear_apply(mp["down"], h)
        assert fused.dtype == x.dtype and torch.equal(fused, two)


def _to_jax_packed(p: PackedLinear):
    return jpack.PackedLinear(
        qweight=jnp.asarray(p.qweight.numpy()),
        scales=jnp.asarray(p.scales.numpy()),
        zeros=jnp.asarray(p.zeros.numpy()),
        input_scale=jnp.asarray(p.input_scale.numpy()),
        bias=None, group_size=p.group_size)


@pytest.mark.parametrize("kind", ["rtn", "awq"])
def test_fused_mlp_matches_jax_mlp(packed_models, kind):
    cfg, params = packed_models
    jcfg = jcfgs.smoke_config()
    layer = params[kind]["segments"]["seg_0"][1]
    jlayer = {"mlp": {n: _to_jax_packed(layer["mlp"][n])
                      for n in ("gate", "up", "down")}}
    x = np.random.default_rng(6).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = blocks._mlp_apply(layer, xb, cfg, cfg.layer_kinds()[1])
    jout, _ = jblocks._mlp_apply(jlayer, jnp.asarray(x, jnp.bfloat16), jcfg,
                                 jcfg.layer_kinds()[1], None)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), **BF16)


def test_fusion_is_chosen_from_the_parameters(packed_models):
    """Float weights (calibration), a bias, another group size or another
    activation keep the two linears; the choice never comes from a
    failure."""
    cfg, params = packed_models
    mp = params["rtn"]["segments"]["seg_0"][0]["mlp"]
    g, u = mp["gate"], mp["up"]
    assert blocks._fused_gateup(mp, cfg)
    assert not blocks._fused_gateup({"gate": {"w": None}, "up": u}, cfg)
    assert not blocks._fused_gateup(
        {"gate": g, "up": dataclasses.replace(u, bias=torch.zeros(u.n))}, cfg)
    assert not blocks._fused_gateup(
        {"gate": g, "up": dataclasses.replace(u, group_size=32)}, cfg)
    assert not blocks._fused_gateup(
        mp, dataclasses.replace(cfg, act="gelu"))


def test_hybrid_threshold_counts_the_pair():
    """2·M·K·2N below `offload_min_flops` takes the plain version even
    when the kernel is selected; both paths count into `COUNTS`."""
    k, n, gs = 128, 64, 64
    g, u = _to_port(_packed(k, n, gs, 10)), _to_port(_packed(k, n, gs, 11))
    x = torch.ones(2, k, dtype=torch.bfloat16)
    flops = 2 * 2 * k * 2 * n
    for limit, path in ((flops + 1, "generic"), (flops, "kernel")):
        cfg = tql.ExecutionConfig(impl="kernel", offload_min_flops=limit)
        before = dataclasses.asdict(tql.COUNTS)
        tql.qgateup_apply(g, u, x, cfg=cfg)
        after = dataclasses.asdict(tql.COUNTS)
        assert {p: after[p] - before[p] for p in after} == {
            "kernel": int(path == "kernel"), "generic": int(path == "generic")}
    assert k1.GATEUP_COUNTER.count == 0      # CPU tensors launch nothing
