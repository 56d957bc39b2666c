"""Port parity: the whole model on bridged parameters vs the JAX package.

Qwen2.5's smoke config with its real grouping (14 q heads over 2 kv
heads, G = 7), f32 activations and f32 quantized compute, float and
AWQ-packed (RTN, GS 64) weights. The bridge carries parameters and
pools bit for bit.

Tolerances: logits at rtol/atol 1e-4 where every cached value is f32 or
int8 — the two frameworks sum the same f32 products in another order,
which leaves ~1e-6; 1e-4 is two orders above that and two below a real
fault. Where K/V are cached in bf16 (the reference's default cache
dtype), a ~1e-7 difference occasionally rounds one element to the
neighbouring bf16 value (2^-8 relative), and such flips compound over
decode steps (measured up to 2.3e-3 after 8 steps): those paths use
5e-3. Int8 page codes must be equal; their f32 scale strips are compared
at rtol 2e-5 and bf16 pool values at 2e-2 (one bf16 rounding). Logits of
an all-padding row attend over nothing and are not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen25_05b as jcfgs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.models import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear
from repro_torch.core.qlinear import ExecutionConfig, execution_config
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


TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16_CACHE = dict(rtol=5e-3, atol=5e-3)


def _cfgs():
    kw = dict(num_heads=14, num_kv_heads=2, activation_dtype="float32")
    return (dataclasses.replace(jcfgs.smoke_config(), **kw),
            dataclasses.replace(tcfgs.smoke_config(), **kw))


@pytest.fixture(scope="module")
def models():
    """{"float" | "awq": (jax model, jax params, port model, port params),
    "jax_report": the JAX PTQReport}"""
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jq, jreport = jpipe.quantize_params(jp)
    out = {"jax_report": jreport}
    for name, p in (("float", jp), ("awq", jq)):
        tp = bridge.params_to_torch(
            jax.tree_util.tree_map(np.asarray, p), device="cpu")
        out[name] = (jm, p, tm, tp)
    return out


@pytest.fixture(autouse=True)
def f32_compute():
    """f32 quantized compute on both sides (the JAX config is reset by
    tests/conftest.py after every test)."""
    jql.set_execution_config(compute_dtype=jnp.float32)
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        yield


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    elif hasattr(node, "qweight"):
        for f in ("qweight", "scales", "zeros", "input_scale", "bias"):
            yield f"{prefix}.{f}", getattr(node, f)
    else:
        yield prefix, node


@pytest.mark.parametrize("kind", ["float", "awq"])
def test_bridge_round_trip_bit_exact(models, kind):
    _, jp, _, tp = models[kind]
    seg = tp["segments"]["seg_0"]
    jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    n = 0
    for i, layer in enumerate(seg):
        for path, t in _leaves(layer):
            ref = jleaves[f"/segments/seg_0{path}"]
            if t is None:
                assert ref is None
                continue
            ref = np.array(ref[i])
            assert t.dtype == torch.from_numpy(ref).dtype
            np.testing.assert_array_equal(t.numpy(), ref)
            n += 1
    np.testing.assert_array_equal(tp["embed"]["table"].numpy(),
                                  jleaves["/embed/table"])
    assert n > 0
    if kind == "awq":
        assert isinstance(seg[0]["attn"]["wq"], PackedLinear)


def test_bridge_defaults_to_cuda(models):
    """Without ``device`` the bridge targets the card, and raises where
    there is none rather than leaving the weights on the CPU."""
    table = np.arange(6, dtype=np.int32).reshape(2, 3)
    if torch.cuda.is_available():
        assert bridge.to_tensor(table).device.type == "cuda"
        return
    jp = jax.tree_util.tree_map(np.asarray, models["awq"][1])
    for fn, arg in ((bridge.to_tensor, table), (bridge.tree_to_torch, jp),
                    (bridge.params_to_torch, jp),
                    (bridge.paged_cache_to_torch, {"seg_0": {}})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(arg)


def test_port_quantize_params_matches_jax_on_bridged_floats(models):
    """Quantizing the bridged float params in the port gives the JAX
    package's packed words, scales and zeros for every layer."""
    _, _, _, tfloat = models["float"]
    _, _, _, tawq = models["awq"]
    qp, report = tpipe.quantize_params(tfloat)
    jreport = models["jax_report"]
    # the port lists each layer's linear, JAX each scan-stacked one
    assert len(report.quantized) == 2 * len(jreport.quantized) == 14
    assert report.packed_bytes == jreport.packed_bytes
    assert report.compression_ratio == jreport.compression_ratio
    jp = models["float"][1]
    for quantized in (False, True):
        assert tpipe.model_size_bytes(tfloat, quantized) == \
            jpipe.model_size_bytes(jp, quantized)
    assert tpipe.model_size_bytes(qp, False) == \
        jpipe.model_size_bytes(models["awq"][1], False)
    for a, b in zip(_leaves(qp), _leaves(tawq)):
        assert a[0] == b[0]
        if a[1] is None:
            assert b[1] is None
        else:
            np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize("kind", ["float", "awq"])
def test_forward_logits(models, kind):
    jm, jp, tm, tp = models[kind]
    toks = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    jl = np.asarray(jm.forward_logits(jp, {"tokens": jnp.asarray(toks)}))
    tl = tm.forward_logits(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, 512)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


def test_forward_logits_other_branches():
    """One small variant runs the branches Qwen2.5 does not: plain gelu
    MLP, LayerNorm, qk-norm with 1+gamma, partial RoPE, scaled
    embeddings and an untied head."""
    kw = dict(num_layers=1, mlp_type="plain", act="gelu",
              norm_type="layernorm", qk_norm=True, rms_plus_one=True,
              rope_fraction=0.5, scale_embed=True, tie_embeddings=False,
              activation_dtype="float32")
    jm = jbuild(dataclasses.replace(jcfgs.smoke_config(), **kw))
    tm = Model(dataclasses.replace(tcfgs.smoke_config(), **kw))
    jp = jm.init(jax.random.PRNGKey(1))
    # non-trivial norm parameters, so gamma / beta / 1+gamma all matter
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32) if "norm" in jax.tree_util.keystr(path) else a, jp)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    assert "lm_head" in tp
    toks = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int32)
    jl = np.asarray(jm.forward_logits(jp, {"tokens": jnp.asarray(toks)}))
    tl = tm.forward_logits(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_prefill_then_decode(models, kind, cache):
    jm, jp, tm, tp = models[kind]
    tol = TOL if cache == "float32" else TOL_BF16_CACHE
    toks = np.random.default_rng(2).integers(0, 512, (2, 9)).astype(np.int32)
    jc = jm.init_cache(2, 32, dtype=getattr(jnp, cache))
    tc = tm.init_cache(2, 32, dtype=getattr(torch, cache), device="cpu")
    jc, jl, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def _chunk_steps():
    """Two unified steps over 3 slots, 4 pages of 8 tokens each: a
    prefill chunk + a short prompt + an empty row, then the next chunk
    (crossing a page) + a decode token + the empty row again."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (2, 3, 8)).astype(np.int32)
    pos1 = np.full((3, 8), -1, np.int32)
    pos1[0] = np.arange(8)
    pos1[1, :5] = np.arange(5)
    pos2 = np.full((3, 8), -1, np.int32)
    pos2[0] = np.arange(8, 16)
    pos2[1, 0] = 5
    return [(toks[0], pos1, np.array([7, 4, 0], np.int32)),
            (toks[1], pos2, np.array([7, 0, 0], np.int32))]


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_chunk_step_logits_and_pools(models, kind, kv_quant):
    jm, jp, tm, tp = models[kind]
    tol = TOL if kv_quant == "int8" else TOL_BF16_CACHE
    table = np.array([[3, 5, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(3, 9, 8, 32, kv_quant=kv_quant)
    tcache = bridge.paged_cache_to_torch(
        jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    for toks, pos, sidx in _chunk_steps():
        jl, jcache = jm.chunk_step(jp, jcache, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(sidx),
                                   jnp.asarray(table))
        tl, tcache = tm.chunk_step(tp, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(sidx),
                                   page_table=torch.from_numpy(table))
        live = pos[np.arange(3), sidx] >= 0
        assert live.sum() == 2
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **tol)
    jpools = jax.tree_util.tree_map(np.asarray, jcache)["seg_0"]["kv_pool"]
    for i, layer in enumerate(tcache["seg_0"]):
        pool = layer["kv_pool"]
        # page 0 is scratch: padding writes land there in no fixed order
        for key in ("k", "v"):
            got = pool[key][1:].float().numpy()
            ref = np.asarray(jpools[key][i, 1:], np.float32)
            if kv_quant == "int8":
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
        for key in ("ks", "vs") if kv_quant == "int8" else ():
            np.testing.assert_allclose(pool[key][1:].numpy(),
                                       jpools[key][i, 1:], rtol=2e-5)
        assert pool["k"][1:].float().abs().sum() > 0
