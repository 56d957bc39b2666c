"""Tensor parallelism in the port, held against the JAX package: the
sharding rules, K2-TP's plain version and the sharded chunk step.

One config variant, as the reference's sharded-serving test uses:
Qwen2.5's smoke config with 8 q / 4 kv heads of 16, so a ``model`` axis
of 2 and of 4 both divide the kv heads, and at 4 the packed ``wo``'s
K-shard (128 / 4 = 32) would split a 64-row quant group: it flips to
column-parallel. Shards live on the CPU, in this one process (an
explicit device list that repeats ``cpu``).

  * rules — the port's `param_pspec` / `paged_cache_pspec` give the
    reference's spec for every leaf of the float and the RTN-packed
    trees and of the pools, at ``model`` 1, 2 and 4 (a reference leaf
    stacks the layers, so its spec is the port's with a leading None);
  * K2-TP — `paged_attention_chunk_sharded_ref`, joined over heads, is
    bit-equal to `paged_attention_chunk_ref` over all heads (C 1, C 16,
    and C 8 with an ancestor mask, logical positions and a window);
  * the model — the sharded `chunk_step` at mesh 2 and 4 from the
    bridged reference params against the reference's unsharded
    `Model.chunk_step`, f32 activations, float and packed, at rtol 2e-5
    with an absolute 2e-5 for logits near 0 (the largest difference
    measured is 5.4e-7 on logits up to 0.8, the two frameworks summing
    the same f32 products in another order; on the CPU the port's
    sharded logits equal its unsharded ones bit for bit: partial
    products stay in float64 until the one rounding after their sum);
    mesh 1 is bit-equal to the port's unsharded step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import qwen25_05b as jcfgs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core import qlinear as tql
from repro_torch.core.packing import PackedLinear
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import paged_attention as k2
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.utils.tree import layer_parts

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    kw = dict(num_heads=8, num_kv_heads=4, head_dim=16, **kw)
    return (dataclasses.replace(jcfgs.smoke_config(), **kw),
            dataclasses.replace(tcfgs.smoke_config(), **kw))


def _mesh(n: int):
    return tshd.serving_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def models():
    """{"float" | "awq": (jax model, jax params, port model, port params)}"""
    jcfg, tcfg = _cfgs(activation_dtype="float32")
    jm, tm = jbuild(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jq, _ = jpipe.quantize_params(jp)
    return {name: (jm, p, tm, bridge.params_to_torch(
                jax.tree_util.tree_map(np.asarray, p), device="cpu"))
            for name, p in (("float", jp), ("awq", jq))}


@pytest.fixture(autouse=True)
def f32_compute():
    """f32 quantized compute on both sides (the JAX config is reset by
    tests/conftest.py after every test)."""
    jql.set_execution_config(compute_dtype=jnp.float32)
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        yield


def _port_specs(tree, rule, mesh, cfg) -> dict:
    """{reference path: the port's spec}, a restacked path's spec given
    the stacked leading dim the reference's leaf has."""
    out = {}
    for path, parts, leaf in layer_parts(tree):
        spec = rule(path, parts[0] if parts is not None else leaf, mesh, cfg)
        out[path] = ((None,) + spec) if parts is not None else spec
    return out


def _ref_specs(tree, rule, n, cfg) -> dict:
    mesh = AbstractMesh((n,), ("model",))
    return {path: tuple(rule(path, leaf, mesh, cfg))
            for path, leaf in jflatten(tree)}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_param_rules_equal_reference(models, kind, n):
    jm, jp, tm, tp = models[kind]
    got = _port_specs(tp, tshd.param_pspec, _mesh(n), tm.cfg)
    want = _ref_specs(jp, jshd.param_pspec, n, jm.cfg)
    assert got == want
    if kind == "awq" and n == 4:
        # the packed wo flips to N (K / 4 = 32 rows split a 64-row group)
        assert got["segments/seg_0/attn/wo/qweight"] == (None, None, "model")
        assert got["segments/seg_0/attn/wo/input_scale"] == (None, "model")
    if n > 1:
        assert got["embed/table"] == ("model", None)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_pool_rules_equal_reference(models, kv_quant, n):
    jm, _, tm, _ = models["float"]
    tcache = tm.init_paged_cache(9, 8, kv_quant=kv_quant, device="meta")
    jcache = jm.init_paged_cache(3, 9, 8, 32, kv_quant=kv_quant)
    got = _port_specs(tcache, tshd.paged_cache_pspec, _mesh(n), None)
    assert got == _ref_specs(jcache, jshd.paged_cache_pspec, n, None)
    assert got["seg_0/kv_pool/k"][-2] == "model"


@pytest.mark.parametrize("n", [2, 4])
def test_shard_tree_pools_are_own_contiguous_allocations(models, n):
    """A pool's pieces are fresh contiguous tensors (K2 reads them as
    such), their join over heads is the unsharded pool, and a meta layout
    sharded under a mesh allocates zeros of the pieces' shapes."""
    _, _, tm, _ = models["float"]
    mesh = _mesh(n)
    gen = torch.Generator().manual_seed(n)
    pool = tm.init_paged_cache(9, 8, kv_quant="int8", device="cpu")
    for leaf in pool["seg_0"][0]["kv_pool"].values():
        leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen)
                   .to(leaf.dtype))
    shards = tshd.shard_tree(pool, mesh, tshd.paged_cache_pspec)
    laid = tm.init_paged_cache(9, 8, kv_quant="int8", mesh=mesh)
    assert len(shards) == len(laid) == n
    for name, whole in pool["seg_0"][0]["kv_pool"].items():
        pieces = [s["seg_0"][0]["kv_pool"][name] for s in shards]
        dim = -2 if name in ("k", "v") else -1
        assert torch.equal(torch.cat(pieces, dim=dim), whole)
        for p, lay in zip(pieces, laid):
            lp = lay["seg_0"][0]["kv_pool"][name]
            assert p.is_contiguous() and p.untyped_storage().data_ptr() \
                != whole.untyped_storage().data_ptr()
            assert lp.shape == p.shape and not lp.any()
            assert p.shape[dim] == whole.shape[dim] // n


def test_shard_params_make_each_packed_shard_whole(models):
    """At mesh 4 the packed wq splits over N but its bias and the wo
    flip's scales / zeros keep the reference's replicated rule;
    `shard_params` gives each shard its own columns of them, and marks
    every split linear ``shards = 4``."""
    _, _, tm, tp = models["awq"]
    shards = tshd.shard_params(tp, _mesh(4), tm.cfg)
    for s, sh in enumerate(shards):
        attn = sh["segments"]["seg_0"][0]["attn"]
        full = tp["segments"]["seg_0"][0]["attn"]
        for name in ("wq", "wo"):
            p, f = attn[name], full[name]
            assert isinstance(p, PackedLinear) and p.shards == 4
            cols = slice(s * p.n, (s + 1) * p.n)
            assert torch.equal(p.scales, f.scales[:, cols])
            assert torch.equal(p.zeros, f.zeros[:, cols])
        assert torch.equal(attn["wq"].bias, full["wq"].bias[s * 32:
                                                            (s + 1) * 32])
        assert attn["wo"].input_scale.shape == (32,)       # K-split
        assert sh["embed"]["table"].shape == (128, 128)    # vocab / 4


@pytest.mark.parametrize("vocab,n,dim", [(512, 2, -2), (513, 2, -1),
                                         (512, 3, None)],
                         ids=["vocab", "d", "replicated"])
def test_embedding_and_tied_head_under_each_table_split(vocab, n, dim):
    """The tied table's three rules: vocab-parallel, split over d (a
    vocab the axis does not divide) and replicated (neither divides). The
    lookup equals the unsharded one bit for bit; so do the head's logits,
    whose products sum over the unsplit d, but for the d split, which
    sums the shards' partial products (f64 here) and rounds once."""
    _, tcfg = _cfgs()
    m = Model(dataclasses.replace(tcfg, vocab_size=vocab))
    gen = torch.Generator().manual_seed(n)
    table = torch.randn(vocab, 128, generator=gen)
    mesh = _mesh(n)
    assert tshd.split_dim(tshd.param_pspec("embed/table", table, mesh)) \
        == dim
    shards = tshd.shard_tree({"embed": {"table": table}}, mesh,
                             tshd.param_pspec)
    devices = tshd.model_devices(mesh)
    tokens = torch.tensor([[0, 5, vocab - 1], [300, 2, 257]])
    got = layers.embed_lookup_tp([s["embed"]["table"] for s in shards],
                                 tokens, devices, vocab, 128, scale=True)
    assert torch.equal(got, layers.embed_lookup({"table": table}, tokens,
                                                scale=True))
    x = torch.randn(3, 128, generator=gen)
    lg = m._head_logits_tp(shards, x, devices)
    want = m._head_logits({"embed": {"table": table}}, x)
    if dim == -1:
        torch.testing.assert_close(lg, want, rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(lg, want)


@pytest.mark.parametrize("mode", ["column", "row", "row_whole_input",
                                  "replicated", "flipped"])
def test_linear_tp_modes_equal_linear(mode):
    """`layers.linear_tp` under each split the rules give a linear: its
    output joined (column) or summed (row, from a split or a whole
    input; the flip: a packed row-parallel linear over N, its input scaled
    slice by slice) equals `linear` on the whole weight bit for bit on the
    CPU, a replicated linear too (its split input joined first)."""
    from repro_torch.core.packing import pack_linear
    from repro_torch.core.quantize import QuantConfig, quantize_groupwise
    name, k, n_out, n = {"column": ("up", 128, 256, 2),
                         "row": ("down", 256, 128, 2),
                         "row_whole_input": ("down", 256, 128, 2),
                         "replicated": ("up", 128, 250, 4),
                         "flipped": ("wo", 128, 96, 4)}[mode]
    gen = torch.Generator().manual_seed(7)
    w = torch.randn(k, n_out, generator=gen) / 12
    p = {"w": w, "b": torch.randn(n_out, generator=gen)}
    if mode == "flipped":
        qc = QuantConfig(group_size=64)
        q, sc, zr = quantize_groupwise(w, qc)
        p = pack_linear(q, sc, zr, torch.rand(k, generator=gen) + 0.5,
                        p["b"], qc)
    mesh = _mesh(n)
    devices = tshd.model_devices(mesh)
    ps = [sh["lin"][name] for sh in tshd.shard_params({"lin": {name: p}},
                                                      mesh)]
    x = torch.randn(5, k, generator=gen)
    split_in = mode in ("row", "replicated", "flipped")
    y = layers.linear_tp(ps, tshd.split(x, -1, devices) if split_in else x,
                         devices, k, n_out)
    if isinstance(y, list):
        y = tshd.concat(y, -1, devices)
    assert torch.equal(y, layers.linear(p, x))
    if mode == "flipped":
        assert ps[0].n == n_out // n and ps[0].input_scale.shape == (k // n,)


def test_hybrid_threshold_decides_on_the_global_shape():
    """A shard's `qlinear_apply` takes the path the unsharded linear
    takes: at M 4 a [128, 256] linear (2·4·128·256 = 262,144 flops) is
    under a threshold of 300,000 and a [128, 512] one is over it, whatever
    the shard's own N."""
    cfg = ExecutionConfig(impl="kernel", offload_min_flops=300_000,
                          compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 128, generator=gen)
    for n, want in ((256, "generic"), (512, "kernel")):
        full = PackedLinear(
            qweight=torch.zeros(16, n, dtype=torch.int32),
            scales=torch.ones(2, n), zeros=torch.zeros(2, n, dtype=torch.int8),
            input_scale=torch.ones(128), bias=None, group_size=64)
        shard = dataclasses.replace(
            full, qweight=full.qweight[:, :n // 4].contiguous(),
            scales=full.scales[:, :n // 4].contiguous(),
            zeros=full.zeros[:, :n // 4].contiguous(), shards=4)
        for p in (full, shard):
            tql.COUNTS.kernel = tql.COUNTS.generic = 0
            tql.qlinear_apply(p, x, cfg=cfg)
            assert getattr(tql.COUNTS, want) == 1, (n, p.shards)


# ---------------------------------------------------------------------------
# K2-TP's plain version
# ---------------------------------------------------------------------------

def _k2_case(case: str):
    """q, pools, table, pos and options for B 3 slots of 4 pages of 8,
    Hkv 4, G 2, hd 16."""
    rng = np.random.default_rng({"decode": 0, "chunk": 1, "tree": 2}[case])
    b, hkv, g, hd, page, nblk = 3, 4, 2, 16, 8, 4
    npages = b * nblk + 1
    c = {"decode": 1, "chunk": 16, "tree": 8}[case]
    kp = torch.from_numpy(rng.integers(-127, 128, (npages, page, hkv, hd))
                          .astype(np.int8))
    vp = torch.from_numpy(rng.integers(-127, 128, (npages, page, hkv, hd))
                          .astype(np.int8))
    ks = torch.from_numpy(rng.random((npages, page, hkv), np.float32) / 50)
    vs = torch.from_numpy(rng.random((npages, page, hkv), np.float32) / 50)
    table = torch.from_numpy(rng.permutation(npages - 1).astype(np.int32)
                             + 1).reshape(b, nblk)
    q = torch.from_numpy(rng.standard_normal((b, c, hkv, g, hd))
                         .astype(np.float32))
    kw = {}
    if case == "decode":
        pos = torch.tensor([[-1], [9], [31]], dtype=torch.int32)
    else:
        base = torch.tensor([0, 9, 32 - c], dtype=torch.int32)
        pos = base[:, None] + torch.arange(c, dtype=torch.int32)[None]
        pos[1, c // 2:] = -1
    if case == "tree":
        parents = [-1, 0, 1, 0, 3, 1, 5, 2]
        anc = torch.zeros(c, c, dtype=torch.bool)
        depth = [0] * c
        for j, par in enumerate(parents):
            if par >= 0:
                anc[j] = anc[par]
                depth[j] = depth[par] + 1
            anc[j, j] = True
        amask = anc[None].expand(b, c, c) & (pos >= 0)[:, None, :]
        rpos = torch.where(pos >= 0, pos[:, :1] + torch.tensor(
            depth, dtype=torch.int32)[None], pos)
        kw = dict(rpos=rpos, amask=amask.contiguous(), window=12)
    return q, (kp, ks, vp, vs), table, pos, kw


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["decode", "chunk", "tree"])
def test_k2_tp_plain_joined_equals_k2_plain(case, n):
    q, (kp, ks, vp, vs), table, pos, kw = _k2_case(case)
    mesh = _mesh(n)
    devices = tshd.model_devices(mesh)
    cut = [tshd.split(t, dim, devices)
           for t, dim in ((q, 2), (kp, -2), (ks, -1), (vp, -2), (vs, -1))]
    outs = k2.paged_attention_chunk_sharded_ref(
        *cut, table, pos, mesh=mesh, scale=0.25, **kw)
    want = k2.paged_attention_chunk_ref(q, kp, ks, vp, vs, table, pos,
                                        scale=0.25, **kw)
    assert len(outs) == n and all(o.shape[2] == 4 // n for o in outs)
    assert torch.equal(torch.cat(outs, dim=2), want)
    # the wrapper takes its plain version for CPU tensors
    wrapped = k2.paged_attention_chunk_sharded(*cut, table, pos, mesh=mesh,
                                               scale=0.25, **kw)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, outs))
    assert want.abs().sum() > 0


def test_k2_tp_refuses_a_shard_count_off_the_mesh():
    q, (kp, ks, vp, vs), table, pos, _ = _k2_case("decode")
    with pytest.raises(ValueError, match="holds 1 shards, the mesh 2"):
        k2.paged_attention_chunk_sharded([q], [kp], [ks], [vp], [vs], table,
                                         pos, mesh=_mesh(2))


# ---------------------------------------------------------------------------
# The sharded chunk step
# ---------------------------------------------------------------------------

def _steps():
    """Two unified steps over 3 slots (a prefill chunk + a short prompt +
    an empty row, then the next chunk crossing a page + a decode token)."""
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


TABLE = np.array([[3, 5, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0]], np.int32)


def _port_logits(tm, params, kv_quant, mesh=None):
    cache = (tm.init_paged_cache(9, 8, kv_quant=kv_quant, mesh=mesh)
             if mesh is not None
             else tm.init_paged_cache(9, 8, kv_quant=kv_quant, device="cpu"))
    out = []
    for toks, pos, sidx in _steps():
        lg, cache = tm.chunk_step(params, cache, torch.from_numpy(toks),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(sidx),
                                  page_table=torch.from_numpy(TABLE),
                                  mesh=mesh)
        out.append(lg.numpy())
    return out, cache


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_sharded_chunk_step_matches_reference(models, kind, n):
    jm, jp, tm, tp = models[kind]
    mesh = _mesh(n)
    got, cache = _port_logits(tm, tshd.shard_params(tp, mesh, tm.cfg),
                              "int8", mesh)
    jcache = jm.init_paged_cache(3, 9, 8, 32, kv_quant="int8")
    for (toks, pos, sidx), lg in zip(_steps(), got):
        jl, jcache = jm.chunk_step(jp, jcache, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(sidx),
                                   jnp.asarray(TABLE))
        live = pos[np.arange(3), sidx] >= 0
        np.testing.assert_allclose(lg[live], np.asarray(jl)[live], **TOL)
    # the shards' int8 codes, joined over heads, are the reference's
    jk = np.asarray(jcache["seg_0"]["kv_pool"]["k"])
    for i in range(tm.cfg.num_layers):
        k = torch.cat([c["seg_0"][i]["kv_pool"]["k"] for c in cache], dim=-2)
        np.testing.assert_array_equal(k[1:].numpy(), jk[i, 1:])
    # and on the CPU the sharded logits are the port's unsharded ones
    plain, _ = _port_logits(tm, tp, "int8")
    assert all(np.array_equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_mesh_one_is_bit_equal_to_unsharded(models, kind, kv_quant):
    _, _, tm, tp = models[kind]
    mesh = _mesh(1)
    got, _ = _port_logits(tm, tshd.shard_params(tp, mesh, tm.cfg), kv_quant,
                          mesh)
    want, _ = _port_logits(tm, tp, kv_quant)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
