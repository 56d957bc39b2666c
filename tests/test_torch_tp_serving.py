"""Tensor-parallel serving in the port: `GenerationEngine(mesh=...)` and
what reaches it, held against the port's own unsharded engine.

The reference's feature matrix (`tests/test_sharded_serving.py`) on the
port, shards on the CPU in this one process (`serving_mesh(n,
devices=["cpu"] * n)`), on Qwen2.5's smoke config with 8 q / 4 kv heads
of 16. JAX serving streams are no oracle here (ROADMAP, "Reference
caveats"); the model's sharded logits are held against the reference in
`tests/test_torch_tp.py`.

  * greedy streams at mesh 1, 2 and 4 equal the unsharded engine's with
    int8 pools × prefix sharing × n-gram speculation (``spec_k`` 4), and
    with bf16 pools at mesh 2; speculation and prefix sharing fire; the
    host pager's integers equal the unsharded engine's, no page stays in
    use; the per-shard pool bytes are exactly 1/n of mesh 1's, which
    equal the unsharded engine's;
  * at mesh 2: AWQ-packed (RTN) weights; preemption, whose spill strips
    are the shards' KV-head pieces joined and whose restore puts the
    pages back bit for bit; token trees; a Router over two mesh-2
    replicas; disaggregation with a prefill mesh of 4 and a decode mesh
    of 2 (streams equal the unified engine's, ``wire_bytes`` the
    unsharded pair's);
  * construction errors carry the reference's words: indivisible kv
    heads, no ``model`` axis, the one-shot path and the families that
    keep per-slot state, ``serving_mesh`` with too few cards; a
    ``(data, model)`` mesh with ``data`` 2 serves as its ``model`` stripe.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import qwen25_05b
from repro_torch.core.pipeline import quantize_params
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import FleetSpec, ReplicaSpec
from repro_torch.models.model import Model
from repro_torch.serving.disagg import DisaggController
from repro_torch.serving.engine import GenerationEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


KW = dict(max_seq=64, num_slots=4, page_size=8, prefill_chunk=4)
FULL = dict(kv_quant="int8", spec_decode="ngram", spec_k=4)


def _mesh(n: int):
    return shd.serving_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def model_params():
    cfg = dataclasses.replace(qwen25_05b.smoke_config(), num_heads=8,
                              num_kv_heads=4, head_dim=16)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    return m, {"float": p, "awq": quantize_params(p)[0]}


@pytest.fixture(scope="module")
def prompts(model_params):
    m, _ = model_params
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, m.cfg.vocab_size, 16).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(
        0, m.cfg.vocab_size, t).astype(np.int32)]) for t in (5, 12, 9, 3)]


def _pager_ints(eng) -> dict:
    p = eng._scheduler.pager
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free=sorted(p.free_pages), used=p.stats().pages_used,
                index=dict(p.prefix_index))


def _serve(m, params, prompts, mesh, warmup=False, **kw):
    eng = GenerationEngine(m, params, mesh=mesh, **{**KW, **kw})
    if warmup:
        assert eng.warmup() > 0
    rids = [eng.submit(p, 10, prefix_id="sys") for p in prompts]
    out = eng.drain()
    return eng, [out[r].tolist() for r in rids]


@pytest.fixture(scope="module")
def unsharded(model_params, prompts):
    m, params = model_params
    return {name: _serve(m, params["float"], prompts, None, **kw)
            for name, kw in (("full", FULL), ("plain", {}))}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_streams_pager_and_pool_bytes_equal_unsharded(model_params, prompts,
                                                      unsharded, n):
    m, params = model_params
    ref_eng, ref = unsharded["full"]
    fresh = GenerationEngine(m, params["float"], mesh=_mesh(n),
                             **{**KW, **FULL}).stats()
    eng, got = _serve(m, params["float"], prompts, _mesh(n),
                      warmup=n == 2, **FULL)
    assert got == ref and all(len(s) == 10 for s in got)
    st, rst = eng.stats(), ref_eng.stats()
    assert rst.draft_tokens > 0 and rst.prefix_shared_pages > 0
    assert (st.draft_tokens, st.accepted_tokens, st.prefix_shared_pages) \
        == (rst.draft_tokens, rst.accepted_tokens, rst.prefix_shared_pages)
    assert _pager_ints(eng) == _pager_ints(ref_eng)
    assert st.pager.pages_used == 0
    assert st.model_axis == n and rst.model_axis == 1
    assert st.kv_pool_bytes == rst.kv_pool_bytes
    assert st.kv_pool_bytes_per_device * n == rst.kv_pool_bytes_per_device
    # a fresh engine reports the same bytes without allocating its pools
    assert fresh.kv_pool_bytes_per_device == st.kv_pool_bytes_per_device
    # every shard's pools are its own, on its device, 1/n of the kv heads
    pools = [c["seg_0"][0]["kv_pool"]["k"] for c in eng._paged_cache]
    assert len(pools) == n and all(p.shape[-2] == 4 // n for p in pools)
    assert len({p.data_ptr() for p in pools}) == n


def test_bf16_pools_mesh2_equal_unsharded(model_params, prompts, unsharded):
    m, params = model_params
    _, got = _serve(m, params["float"], prompts, _mesh(2))
    assert got == unsharded["plain"][1]


def test_awq_mesh2_equal_unsharded(model_params, prompts):
    m, params = model_params
    _, ref = _serve(m, params["awq"], prompts, None, **FULL)
    _, got = _serve(m, params["awq"], prompts, _mesh(2), **FULL)
    assert got == ref


def test_preemption_mesh2_spills_whole_strips_and_restores_bit_exact(
        model_params, prompts, unsharded):
    """A preempted slot's pages leave as whole strips — the shards'
    KV-head pieces joined, exactly — and come back into fresh pages bit
    for bit; the streams equal an engine that never preempts."""
    m, params = model_params
    eng = GenerationEngine(m, params["float"], mesh=_mesh(2),
                           preemption=True, **{**KW, **FULL})
    rids = [eng.submit(p, 10, prefix_id="sys") for p in prompts]
    sched = eng._scheduler
    spill, restore = sched._spill_fn, sched._restore_fn
    seen = {"spills": 0, "restores": 0}

    def joined(ids):
        return {seg: {leaf: torch.cat(
                    [torch.stack([e["kv_pool"][leaf][ids] for e in c[seg]])
                     for c in eng._paged_cache], dim=dim)
                      for leaf, dim in (("k", -2), ("v", -2), ("ks", -1),
                                        ("vs", -1))}
                for seg in eng._paged_cache[0]}

    def watched_spill(ids):
        want = joined(torch.as_tensor(ids))
        handle = spill(ids)
        for seg, leaves in want.items():
            for leaf, t in leaves.items():
                assert torch.equal(handle["strips"][seg][leaf], t)
        seen["spills"] += 1
        return handle

    def watched_restore(handle, fresh):
        restore(handle, fresh)
        got = joined(torch.as_tensor(fresh))
        for seg, leaves in handle["strips"].items():
            for leaf, t in leaves.items():
                assert torch.equal(got[seg][leaf], t)
        seen["restores"] += 1

    sched._spill_fn, sched._restore_fn = watched_spill, watched_restore
    for _ in range(6):
        eng.step()
    assert eng.preempt(rids[1])
    out = eng.drain()
    assert seen == {"spills": 1, "restores": 1}
    assert [out[r].tolist() for r in rids] == unsharded["full"][1]
    assert eng.stats().pager.pages_used == 0


def test_trees_mesh2_equal_unsharded(model_params, prompts):
    m, params = model_params
    kw = dict(FULL, spec_tree=True, spec_tree_fanout=2)
    ref_eng, ref = _serve(m, params["float"], prompts, None, **kw)
    eng, got = _serve(m, params["float"], prompts, _mesh(2), **kw)
    assert got == ref
    assert eng.stats().draft_tokens == ref_eng.stats().draft_tokens > 0
    assert eng.tree_moves == ref_eng.tree_moves


def test_router_over_two_mesh2_replicas(model_params, prompts):
    """Two mesh-2 replicas behind the Router place and stream as two
    unsharded ones do."""
    m, params = model_params
    runs = []
    for width in (1, 2):
        spec = FleetSpec(replicas=2, replica=ReplicaSpec(
            mesh_axis=width, engine_kwargs=dict(KW, kv_quant="int8")))
        router = spec.build(m, params["float"])
        assert router.warmup() > 0
        rids = [router.submit(p, 8, prefix_id=f"sys{i % 2}")
                for i, p in enumerate(prompts * 2)]
        out = router.drain()
        runs.append(([out[r].tolist() for r in rids],
                     dataclasses.asdict(router.router_stats),
                     [s.model_axis for s in router.stats()]))
    (ref, ref_ledger, ref_axes), (got, ledger, axes) = runs
    assert got == ref and ledger == ref_ledger
    assert ref_axes == [1, 1] and axes == [2, 2]


def test_disagg_prefill_mesh4_decode_mesh2(model_params, prompts,
                                           unsharded):
    """Handoffs leave the 4-way prefill mesh whole and re-stripe over the
    2-way decode mesh: streams equal the unified engine's, and the wire
    image is the unsharded pair's, byte for byte in count."""
    m, params = model_params
    kw = dict(KW, kv_quant="int8", handoff_min_tokens=1)
    _, ref = _serve(m, params["float"], prompts, None, kv_quant="int8")
    stats = []
    for pm, dm in ((None, None), (_mesh(4), _mesh(2))):
        ctrl = DisaggController(m, params["float"], prefill_mesh=pm,
                                decode_mesh=dm, **kw)
        rids = [ctrl.submit(p, 10, prefix_id="sys") for p in prompts]
        out = ctrl.drain()
        assert [out[r].tolist() for r in rids] == ref
        stats.append(ctrl.stats())
    (plain, sharded) = stats
    assert sharded.handoffs == plain.handoffs == len(prompts)
    assert sharded.wire_bytes == plain.wire_bytes > 0
    assert ctrl.prefill.stats().model_axis == 4
    assert ctrl.decode.stats().model_axis == 2


def test_replica_spec_builds_sharded_disagg_pairs(model_params, prompts):
    m, params = model_params
    ctrl = ReplicaSpec(disagg=True, prefill_mesh_axis=2, decode_mesh_axis=4,
                       engine_kwargs=dict(KW, handoff_min_tokens=1)
                       ).build(m, params["float"])
    rid = ctrl.submit(prompts[0], 4)
    assert len(ctrl.drain()[rid]) == 4
    assert (ctrl.prefill.stats().model_axis,
            ctrl.decode.stats().model_axis) == (2, 4)


def test_host_mesh_with_a_unit_data_axis_serves(model_params, prompts,
                                                unsharded):
    m, params = model_params
    mesh = make_host_mesh(1, 2, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 1, "model": 2}
    _, got = _serve(m, params["float"], prompts, mesh, **FULL)
    assert got == unsharded["full"][1]
    # a data axis above 1 serves too, as the reference's engine does: on
    # the first replica's model stripe, the streams and stats of the
    # (model,) mesh of the same width
    eng, got = _serve(m, params["float"], prompts,
                      make_host_mesh(2, 2, devices=["cpu"] * 4), **FULL)
    ref_eng, ref = _serve(m, params["float"], prompts, _mesh(2), **FULL)
    assert got == ref
    assert dataclasses.asdict(eng.stats()) == dataclasses.asdict(
        ref_eng.stats())


def _smoke(arch: str):
    m = Model(configs.get_smoke_config(arch))
    return m, m.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("case", [
    "indivisible", "no_model_axis", "oneshot", "mla", "ssm", "hymba_rings",
    "moe", "params_off_mesh"])
def test_construction_errors(model_params, case):
    """The reference's three ValueErrors, in its words (its
    `test_sharded_serving.py:141-145`), for indivisible kv heads, a mesh
    without a ``model`` axis and the one-shot path (raised when serving
    starts), the one-shot path again for the families with per-slot
    state (MLA, SSM, hymba's rings). A MoE model (qwen2-moe, attention
    + MoE on the chunked path) no longer raises: it serves under the
    mesh, its stream that of the unsharded engine."""
    m, params = model_params
    p = params["float"]
    if case == "indivisible":        # the stock smoke config: Hkv 1
        sm, sp = _smoke("qwen25-05b")
        with pytest.raises(ValueError) as e:
            GenerationEngine(sm, sp, mesh=_mesh(2))
        assert "num_kv_heads=1" in str(e.value)
        assert "divisible" in str(e.value)
        return
    if case == "no_model_axis":
        with pytest.raises(ValueError, match="'model' axis"):
            GenerationEngine(m, p, mesh=shd.Mesh(["cpu", "cpu"], ("data",)))
        return
    if case == "params_off_mesh":
        with pytest.raises(ValueError, match="must hold the params"):
            GenerationEngine(m, p, mesh=shd.serving_mesh(
                2, devices=["meta"] * 2))
        return
    arch, mesh, exc, match = {
        "oneshot": (None, 2, ValueError, "chunked"),
        "mla": ("deepseek-v2-lite-16b", 2, ValueError, "chunked"),
        "ssm": ("mamba2-130m", 2, ValueError, "chunked"),
        "hymba_rings": ("hymba-1.5b", 1, ValueError, "chunked"),
        "moe": ("qwen2-moe-a2.7b", 2, None, None),
    }[case]
    if arch is not None:
        m, p = _smoke(arch)
    if exc is None:
        outs = []
        for mesh_ in (None, _mesh(mesh)):
            eng = GenerationEngine(m, p, max_seq=64, num_slots=2,
                                   page_size=8, mesh=mesh_)
            rid = eng.submit(np.arange(4, dtype=np.int32), 4)
            outs.append(eng.drain()[rid])
        np.testing.assert_array_equal(outs[1], outs[0])
        return
    kw = dict(chunked_prefill=False) if case == "oneshot" else {}
    eng = GenerationEngine(m, p, max_seq=64, num_slots=2, page_size=8,
                           mesh=_mesh(mesh), **kw)
    with pytest.raises(exc, match=match):
        eng.submit(np.arange(4, dtype=np.int32), 4)


def test_serving_mesh_needs_the_cards_unless_given_devices(monkeypatch):
    """On a CUDA machine with one card, a 2-way mesh raises the
    reference's words; an explicit device list co-locates shards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"serving_mesh\(model=2\): have 1 "
                                         r"devices"):
        shd.serving_mesh(2)
    mesh = shd.serving_mesh(2, devices=["cuda:0", "cuda:0"])
    assert shd.model_devices(mesh) == [torch.device("cuda", 0)] * 2
    assert shd.serving_mesh(devices=["cpu"] * 3).shape == {"model": 3}
    with pytest.raises(ValueError, match="have 1 devices"):
        make_host_mesh(1, 2)
