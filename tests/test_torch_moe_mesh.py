"""MoE under a mesh in the port, held against the JAX package.

  * rules — the experts' `param_pspec` (float ``gate`` / ``up`` on F,
    ``down`` on F; packed ``gate`` / ``up`` on F, ``down`` on its output
    D; ``input_scale`` whole) and `zero1_pspec` equal the reference's for
    every leaf of qwen2-moe's and deepseek's float and RTN-packed smoke
    trees, at ``model`` 1, 2 and 4 with ``data`` 2 (a reference leaf
    stacks the layers: its spec is the port's with a leading None); a
    packed shard's expert words, scales and zeros are contiguous,
    16-byte aligned allocations of its own (what K1 / K3 take);
  * the packed forward — `Model.forward_logits(mesh=)` under (2 × 2),
    (2 × 4) and (2 × 1) (qwen2-moe; deepseek: MLA, a dense first layer)
    against the
    reference's meshless forward: the reference's own check
    (`tests/test_moe_sharded.py`), f32 activations and compute, 1e-4;
  * the grouped dispatch — with T / g = 1,100 tokens a group (capacity
    factor 0.5, so tokens drop), the port's per-group `moe_apply_tp` over
    a 2-way ``model`` split against the reference's
    `_dispatch_compute_combine` called once a group, at f32 tolerance;
    the grouped output is not the meshless dispatch's;
  * the aux loss — `Model.loss(mesh=)` under (2 × 2) against the
    reference's (meshless: the global probs and top-1 counts) at f32
    tolerance;
  * serving — qwen2-moe through `GenerationEngine(mesh=)` at 2 (the
    smoke config's 2 kv heads) and 4 (a variant with 8 q / 4 kv heads of
    16), RTN-packed, bf16 pools: greedy streams and the pager's integers
    equal the unsharded engine's.

Shards live on the CPU in this one process (meshes over ``["cpu"] * n``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models.layers import activation as jact
from repro.models.layers import linear as jlinear
from repro.utils.tree import flatten_with_paths as jflatten
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import pipeline as tpipe
from repro_torch.core import qlinear as tql
from repro_torch.distributed import sharding as tshd
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model
from repro_torch.serving.engine import GenerationEngine
from repro_torch.utils.tree import layer_parts

F32 = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers
    share the machine's cores)."""
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


def _mesh(data: int, model: int) -> tshd.Mesh:
    return tshd.Mesh(np.full((data, model), "cpu", dtype=object),
                     ("data", "model"))


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    """(jax model, port model, {"float" | "awq": (jax params, port
    params)}) of one smoke MoE model at f32 activations."""
    name = request.param
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name),
                               activation_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(name),
                               activation_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jq, _ = jpipe.quantize_params(jp)
    return jm, Model(tcfg), {
        kind: (p, bridge.params_to_torch(_np(p), device="cpu"))
        for kind, p in (("float", jp), ("awq", jq))}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_expert_and_zero1_rules_equal_reference(trees, kind, n):
    jm, tm, by_kind = trees
    jp, tp = by_kind[kind]
    jmesh = AbstractMesh((2, n), ("data", "model"))
    tmesh = _mesh(2, n)
    want = {}
    for path, leaf in jflatten(jp):
        spec = jshd.param_pspec(path, leaf, jmesh, jm.cfg)
        want[path] = (tuple(spec), tuple(jshd.zero1_pspec(
            spec, tuple(leaf.shape), jmesh)))
    got = {}
    for path, parts, leaf in layer_parts(tp):
        one = parts[0] if parts is not None else leaf
        spec = tshd.param_pspec(path, one, tmesh, tm.cfg)
        shape = tuple(one.shape)
        if parts is not None:
            spec, shape = (None,) + spec, (len(parts),) + shape
        got[path] = (spec, tshd.zero1_pspec(spec, shape, tmesh))
    assert got == want
    experts = {p: s for p, s in got.items() if "/experts/" in p}
    assert experts
    if n > 1:
        pre = "segments/seg_1" if "deepseek" in tm.cfg.name else \
            "segments/seg_0"
        w = "w" if kind == "float" else "qweight"
        assert got[f"{pre}/moe/experts/gate/{w}"][0][-1] == "model"
        assert got[f"{pre}/moe/experts/down/{w}"][0][
            -2 if kind == "float" else -1] == "model"
    if kind == "awq" and n > 1:
        # K1 / K3 read a shard's stripe of words, scales and zeros as
        # contiguous, 16-byte aligned allocations of its own
        seg = pre.split("/")[-1]
        whole = tp["segments"][seg][0]["moe"]["experts"]
        for sh in tshd.shard_params(tp, tshd.serving_mesh(
                n, devices=["cpu"] * n), tm.cfg):
            for name, lin in sh["segments"][seg][0]["moe"][
                    "experts"].items():
                assert lin.shards == n
                assert torch.equal(lin.input_scale,
                                   whole[name].input_scale)
                for f in ("qweight", "scales", "zeros"):
                    t = getattr(lin, f)
                    assert t.is_contiguous() and t.data_ptr() % 16 == 0
                    assert t.shape[-1] * n == getattr(whole[name],
                                                      f).shape[-1]
                    assert t.untyped_storage().data_ptr() != getattr(
                        whole[name], f).untyped_storage().data_ptr()


def _grid(tp, mesh, cfg):
    return [tshd.shard_params(tp, rm, cfg)
            for rm in tshd.replica_meshes(mesh)]


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (2, 1)],
                         ids=["2x2", "2x4", "2x1"])
def test_packed_forward_under_mesh_matches_meshless_reference(trees, shape):
    jm, tm, by_kind = trees
    jq, tq = by_kind["awq"]
    toks = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (8, 24)).astype(np.int32)
    mesh = _mesh(*shape)
    want = np.asarray(jm.forward_logits(jq, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.forward_logits(_grid(tq, mesh, tm.cfg),
                                {"tokens": torch.from_numpy(toks)},
                                mesh=mesh)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) < 1e-4


def _ref_group(jp, x, jcfg):
    """The reference's manual dispatch on one group: top-k of the router,
    `_dispatch_compute_combine` at ``capacity(T / g)``, then the shared
    experts as `moe_apply` adds them."""
    probs = jax.nn.softmax(jlinear(jp["router"], x), axis=-1)
    gates, idx = jax.lax.top_k(probs, jcfg.top_k)
    if jcfg.norm_topk_prob:
        gates = gates / jnp.clip(jnp.sum(gates, -1, keepdims=True), 1e-9)
    ex = jp["experts"]
    y = jmoe._dispatch_compute_combine(
        x, idx, gates, lambda b: jmoe._glu_ffn(
            b, ex["gate"]["w"], ex["up"]["w"], ex["down"]["w"], jcfg.act),
        jcfg, jmoe.capacity(jcfg, x.shape[0]))
    sh = jp["shared"]
    s_out = jlinear(sh["down"], jact(jcfg.act, jlinear(sh["gate"], x))
                    * jlinear(sh["up"], x))
    if "shared_gate" in jp:
        s_out = s_out * jax.nn.sigmoid(jlinear(jp["shared_gate"], x))
    return y + s_out


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_drops_as_the_reference(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               capacity_factor=0.5)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               capacity_factor=0.5)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    tp = bridge.tree_to_torch(_np(jp), device="cpu")
    g, tg = 2, 1100
    assert tmoe.capacity(tcfg, tg) < tg * tcfg.top_k / tcfg.num_experts * 2
    x = np.random.default_rng(7).standard_normal(
        (g, tg, tcfg.d_model)).astype(np.float32)
    mesh = tshd.serving_mesh(2, devices=["cpu"] * 2)
    shards = tshd.shard_params({"moe": tp}, mesh, tcfg)
    assert shards[0]["moe"]["experts"]["gate"]["w"].shape[-1] \
        == tcfg.moe_d_ff // 2
    devices = tshd.model_devices(mesh)
    got = np.stack([tmoe.moe_apply_tp([s["moe"] for s in shards],
                                      torch.from_numpy(x[i]), tcfg,
                                      devices)[0].numpy()
                    for i in range(g)])
    want = np.stack([np.asarray(_ref_group(jp, jnp.asarray(x[i]), jcfg))
                     for i in range(g)])
    np.testing.assert_allclose(got, want, **F32)
    meshless, _ = jmoe.moe_apply(jp, jnp.asarray(x.reshape(g * tg, -1)),
                                 jcfg)
    assert float(np.abs(np.asarray(meshless).reshape(got.shape)
                        - got).max()) > 1e-3


def test_aux_loss_is_the_global_one():
    name = "qwen2-moe-a2.7b"
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name),
                               activation_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(name),
                               activation_dtype="float32")
    jm, tm = jbuild(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_to_torch(_np(jp), device="cpu")
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    _, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(toks)})
    mesh = _mesh(2, 2)
    with torch.no_grad():
        loss, met = tm.loss(tshd.replica_params(tp, mesh, tcfg),
                            {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(toks)}, mesh=mesh)
        halves = [tm.loss(tp, {"tokens": torch.from_numpy(h),
                               "labels": torch.from_numpy(h)})[1]["aux"]
                  for h in (toks[:2], toks[2:])]
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), **F32)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), **F32)
    # the mean of the replicas' own aux losses is another number
    assert abs(float(sum(halves)) / 2 - float(met["aux"])) > 1e-7


def _pager_ints(eng) -> dict:
    p = eng._scheduler.pager
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free=sorted(p.free_pages), used=p.stats().pages_used)


@pytest.mark.parametrize("n", [2, 4])
def test_engine_serves_moe_under_mesh_as_unsharded(n):
    cfg = tconfigs.get_smoke_config("qwen2-moe-a2.7b")
    if n == 4:
        cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=4,
                                  head_dim=16)
    m = Model(cfg)
    params, _ = tpipe.quantize_params(
        m.init(torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(n)
    prompts = [rng.integers(0, cfg.vocab_size, t).astype(np.int32)
               for t in (5, 19, 11)]
    runs = []
    for mesh in (None, tshd.serving_mesh(n, devices=["cpu"] * n)):
        eng = GenerationEngine(m, params, max_seq=64, num_slots=2,
                               page_size=8, kv_quant="none", mesh=mesh)
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.drain()
        runs.append(([out[r].tolist() for r in rids], _pager_ints(eng),
                     eng.stats()))
    (ref, ref_ints, rst), (got, ints, st) = runs
    assert got == ref and all(len(s) == 8 for s in got)
    assert ints == ref_ints and st.pager.pages_used == 0
    assert st.model_axis == n
    assert st.kv_pool_bytes_per_device * n == rst.kv_pool_bytes_per_device
