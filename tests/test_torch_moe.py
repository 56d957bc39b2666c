"""Port parity: the MoE layer (`models/moe.py`) against the reference's.

The same inputs (numpy, from a seed) and the reference's params
(`moe.moe_init` with a `jax.random` key, carried over by
`bridge.tree_to_torch`) go through both packages' single-device
`moe_apply` on the qwen2-moe smoke config (8 experts, top-2, 2 shared
experts with the sigmoid gate) and deepseek's (top-2 with
``norm_topk_prob``, one shared expert, no gate):

  * routing integers: each token's experts, and the capacity buffer the
    dispatch fills, element for element (it shows every kept token's
    slot and every dropped one), dropless at 16 tokens and in the
    GShard dropping region above 1,024 tokens;
  * ``y`` and the aux loss at the reference's f32 kernel tolerance
    (rtol / atol 2e-5, `tests/test_kernels.py:40`): f32 activations and
    weights on both sides, the two frameworks summing the same products
    in another order;
  * quantized experts: both pipelines pack the same integers (RTN: the
    routed experts record no calibration name), the packed layers agree
    at 2e-5 under f32 compute, and the packed layer equals the float
    layer whose weights are the dequantized ones (the packed path is
    only a different way to the same products);
  * K1 / K3's expert axis: the plain versions against the reference's
    oracles (`kernels/ref.py`) expert by expert, and bit-equal to a loop
    over the single-expert plain versions.

Each test pins PyTorch to one intra-op thread (small ops on an
oversubscribed pool are many times slower under the suite's workers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import packing as jpack
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.core.quantize import QuantConfig as JQuantConfig
from repro.core.quantize import quantize_groupwise as jquantize
from repro.kernels import ref as jref
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import pipeline as tpipe
from repro_torch.core import qlinear as tql
from repro_torch.core.packing import PackedLinear, dequantize_packed
from repro_torch.kernels import awq_matmul as k1
from repro_torch.models import moe as tmoe

F32 = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with tql.execution_config(tql.ExecutionConfig(
            compute_dtype=torch.float32)):
        yield
    jql.set_execution_config(compute_dtype=jnp.bfloat16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(jax cfg, port cfg, jax params, port params) of one smoke MoE layer
    (capacity factor 0.5, so that 1,100 tokens overflow experts)."""
    name = request.param
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name),
                               capacity_factor=0.5)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(name),
                               capacity_factor=0.5)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, bridge.tree_to_torch(_np(jp), device="cpu")


def _x(t, d, seed=0):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


@pytest.mark.parametrize("t", [16, 1100], ids=["dropless", "dropping"])
def test_routing_integers_equal_reference(layer, t):
    """Experts per token, gates, and the capacity buffer (which holds each
    kept token at its slot and nothing of a dropped one) equal the
    reference's; in the dropping region some choices are dropped."""
    jcfg, tcfg, jp, tp = layer
    x = _x(t, tcfg.d_model, seed=t)
    xj = jnp.asarray(x)
    probs = jax.nn.softmax(xj @ jp["router"]["w"], axis=-1)
    jgates, jidx = jax.lax.top_k(probs, jcfg.top_k)
    if jcfg.norm_topk_prob:
        jgates = jgates / jnp.clip(jnp.sum(jgates, -1, keepdims=True), 1e-9)
    cap = jmoe.capacity(jcfg, t)
    seen = []
    jmoe._dispatch_compute_combine(xj, jidx, jgates,
                                   lambda b: seen.append(b) or b, jcfg, cap)

    xt = torch.from_numpy(x)
    tprobs = torch.softmax(tmoe.linear(tp["router"], xt), dim=-1)
    assert tmoe.capacity(tcfg, t) == cap
    idx, gates, slots, keeps = tmoe.route(tprobs, tcfg, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **F32)
    buf = tmoe.dispatch(xt, idx, slots, keeps, tcfg.num_experts, cap)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(seen[0]))
    kept = torch.stack(keeps)
    assert bool(kept.all()) == (t <= 1024)
    assert bool((torch.stack(slots) < cap).all())


@pytest.mark.parametrize("t", [16, 1100], ids=["dropless", "dropping"])
def test_moe_apply_matches_reference(layer, t):
    """``y`` [2, T/2, D] and the aux loss at f32 tolerance, float experts."""
    jcfg, tcfg, jp, tp = layer
    x = _x(t, tcfg.d_model, seed=t + 1).reshape(2, t // 2, -1)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


def test_packed_experts_match_reference_and_float_experts(layer):
    """RTN int4 of the layer: the packed integers equal the reference's
    (routed experts stacked [E, ...], shared experts, router and
    ``shared_gate`` kept float alike); the packed layer agrees with the
    reference's packed layer at f32 tolerance, and equals the float layer
    built from its dequantized weights at the same tolerance."""
    jcfg, tcfg, jp, tp = layer
    jq, jrep = jpipe.quantize_params({"moe": jp})
    tq, trep = tpipe.quantize_params({"moe": tp})
    assert sorted(trep.quantized) == sorted(jrep.quantized)
    assert sorted(trep.skipped) == sorted(jrep.skipped)
    assert trep.packed_bytes == jrep.packed_bytes and not trep.calibrated
    jtree = bridge.tree_to_torch(_np(jq), device="cpu")["moe"]
    packed = [p for p in trep.quantized if "experts" in p]
    assert len(packed) == 3
    for path in trep.quantized:
        _, *keys = path.split("/")
        got, ref = tq["moe"], jtree
        for k in keys:
            got, ref = got[k], ref[k]
        assert isinstance(got, PackedLinear)
        for f in ("qweight", "zeros", "scales", "input_scale"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (path, f)
    x = _x(24, tcfg.d_model, seed=5)
    jy, _ = jmoe.moe_apply(jq["moe"], jnp.asarray(x), jcfg)
    ty, _ = tmoe.moe_apply(tq["moe"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)

    def dense(p):
        if not isinstance(p, PackedLinear):
            return p
        w = torch.stack([dequantize_packed(PackedLinear(
            q, s, z, i, None, p.group_size)) * i[:, None] for q, s, z, i in
            zip(p.qweight.reshape(-1, *p.qweight.shape[-2:]),
                p.scales.reshape(-1, *p.scales.shape[-2:]),
                p.zeros.reshape(-1, *p.zeros.shape[-2:]),
                p.input_scale.reshape(-1, p.k))])
        return {"w": w.reshape(*p.qweight.shape[:-2], p.k, p.n)}

    floats = {k: ({kk: dense(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) and "w" not in v else dense(v))
              for k, v in tq["moe"].items()}
    fy, _ = tmoe.moe_apply(floats, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), fy.numpy(), **F32)


def _stacked(e, k, n, seed):
    """E reference-packed [K, N] linears with input scales, stacked."""
    rng = np.random.default_rng(seed)
    cfg = JQuantConfig(group_size=64)
    packs = []
    for _ in range(e):
        w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.1)
        isc = jnp.asarray(rng.uniform(0.5, 1.5, k).astype(np.float32))
        packs.append(jpack.pack_linear(*jquantize(w, cfg), isc, None, cfg))
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *packs)


@pytest.mark.parametrize("e,m", [(3, 0), (0, 4), (3, 4)])
def test_expert_counters_count_launches_only(monkeypatch, e, m):
    """The expert-axis counters go up where K1 / K3 launch, beside
    `COUNTER` / `GATEUP_COUNTER`, and nowhere else: an E x 0 x K (or 0 x
    M x K) call launches nothing and leaves all four unchanged, and a
    single-linear launch counts no expert launch. The launch helpers run
    here on CPU tensors with the library, the stream and the device check
    stubbed out, so no kernel runs."""
    k, n = 128, 64
    launched = []

    class Lib:
        def awq_matmul(self, *a):
            launched.append("k1")
            return 0

        def awq_gateup_f32(self, *a):
            launched.append("k3")
            return 0

    monkeypatch.setattr(k1, "_check_launch",
                        lambda chk, x, w, *a: (*x.shape, w[0][0].shape[-1]))
    monkeypatch.setattr(k1, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    for name in ("COUNTER", "GATEUP_COUNTER", "EXPERT_COUNTER",
                 "GATEUP_EXPERT_COUNTER"):      # fresh ones, restored after
        monkeypatch.setattr(k1, name, type(k1.COUNTER)())
    qw = torch.zeros(e, k // 8, n, dtype=torch.int32)
    sz = (torch.ones(e, k // 64, n), torch.zeros(e, k // 64, n,
                                                 dtype=torch.int8))
    x = torch.zeros(e, m, k)
    counters = (k1.COUNTER, k1.GATEUP_COUNTER, k1.EXPERT_COUNTER,
                k1.GATEUP_EXPERT_COUNTER)
    k1._launch_matmul(x, qw, *sz, 64, torch.bfloat16, None, torch.float32)
    k1._launch_gateup(x, [(qw, *sz)] * 2, 64, torch.bfloat16, None,
                      torch.float32)
    ran = int(e * m > 0)
    assert launched == ["k1", "k3"] * ran
    assert [c.count for c in counters] == [ran] * 4
    if ran:
        k1._launch_matmul(x[:1], qw[0], sz[0][0], sz[1][0], 64,
                          torch.bfloat16, None, torch.float32)
        assert [c.count for c in counters] == [2, 1, 1, 1]


@pytest.mark.parametrize("m", [1, 5, 20])
def test_stacked_plain_kernels_match_reference_per_expert(m):
    """`awq_gateup_experts` / `awq_matmul_experts` on CPU tensors (their
    plain versions) against the reference's oracles expert by expert (f32
    compute), bit-equal to a loop over the single-expert plain versions,
    and what `qgateup_experts_apply` / `qlinear_experts_apply` return on
    the model's path."""
    e, k, n = 3, 128, 192
    g, u, d = _stacked(e, k, n, 1), _stacked(e, k, n, 2), _stacked(e, n, k, 3)
    x = np.random.default_rng(m).standard_normal((e, m, k)).astype(np.float32)
    tg, tu, td = (bridge.tree_to_torch(t, device="cpu") for t in (g, u, d))
    xt = torch.from_numpy(x)
    kw = dict(input_scales=(tg.input_scale, tu.input_scale))
    h = k1.awq_gateup_experts(xt, tg.qweight, tg.scales, tg.zeros,
                              tu.qweight, tu.scales, tu.zeros, 64,
                              torch.float32, **kw)
    y = k1.awq_matmul_experts(h, td.qweight, td.scales, td.zeros, 64,
                              torch.float32, input_scale=td.input_scale)
    for i in range(e):
        # the oracle's GLU front takes one x: gate and up scale theirs apart
        jg, ju = (jref.awq_matmul_ref(jnp.asarray(x[i] * w.input_scale[i]),
                                      w.qweight[i], w.scales[i], w.zeros[i],
                                      64) for w in (g, u))
        np.testing.assert_allclose(h[i].numpy(),
                                   np.asarray(jax.nn.silu(jg) * ju), **F32)
        jy = jref.awq_matmul_ref(jnp.asarray(h[i].numpy())
                                 * d.input_scale[i][None], d.qweight[i],
                                 d.scales[i], d.zeros[i], 64)
        np.testing.assert_allclose(y[i].numpy(), np.asarray(jy), **F32)
        one = k1.awq_gateup_ref(xt[i], tg.qweight[i], tg.scales[i],
                                tg.zeros[i], tu.qweight[i], tu.scales[i],
                                tu.zeros[i], 64, torch.float32,
                                input_scales=(tg.input_scale[i],
                                              tu.input_scale[i]))
        assert torch.equal(h[i], one)
        assert torch.equal(y[i], k1.awq_matmul_ref(
            h[i], td.qweight[i], td.scales[i], td.zeros[i], 64, torch.float32,
            input_scale=td.input_scale[i]))
    before = tql.PathCounts(**vars(tql.COUNTS))
    cfg = tql.ExecutionConfig(compute_dtype=torch.float32, offload_min_flops=0)
    assert torch.equal(tql.qgateup_experts_apply(tg, tu, xt, impl="kernel",
                                                 cfg=cfg), h)
    assert torch.equal(tql.qlinear_experts_apply(td, h, impl="kernel",
                                                 cfg=cfg), y)
    assert tql.COUNTS.kernel == before.kernel + 2
    assert k1.EXPERT_COUNTER.count == 0 == k1.GATEUP_EXPERT_COUNTER.count
