"""Disaggregated prefill/decode serving and its split policy in the port,
held against the JAX package.

  * pager — `export_slot` / `adopt` accounting run on the port's pager
    and the reference's side by side (cross-pool placement, prefix-key
    aliasing, capacity refusal without mutation, sticky pins): equal
    results and equal state after every call;
  * engine — a `PrefillEngine` parks at the first token and wires a
    `KVHandoff` with the JAX prefill engine's layout and ``wire_bytes``
    (13 tokens over 2 pages, bf16 and int8 pools) and its own pool's
    bytes exactly, and an adopting `DecodeEngine` holds exactly those
    bytes in its pool;
  * controller — `DisaggController` streams equal the port's unified
    engine, and its `DisaggStats` integers equal the reference
    controller's for the same traffic;
  * costmodel — `cell_costs` equals the reference's exactly, and
    `disagg_report` gives the reference's crossover under the reference's
    machine constants.

The launcher's ``--replicas 2 --disagg`` path is held in
`tests/test_torch_disagg_launch.py`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro.roofline import costmodel as jcost
from repro.serving import disagg as jdisagg
from repro.serving import kv_pager as jkv
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.configs import qwen25_05b
from repro_torch.distributed import serving_mesh
from repro_torch.launch.specs import ReplicaSpec
from repro_torch.models.model import Model
from repro_torch.roofline import costmodel as tcost
from repro_torch.serving import disagg as tdisagg
from repro_torch.serving import kv_pager as tkv
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.router import Router


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Pager-level export/adopt accounting, port and reference side by side
# ---------------------------------------------------------------------------

def _pager_state(p):
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free_pages=list(p.free_pages), free_slots=list(p.free_slots),
                slot_pages={k: list(v) for k, v in p.slot_pages.items()},
                slot_len=p.slot_len.tolist(), reserved=dict(p.slot_reserved),
                committed=dict(p.slot_committed), version=p.version,
                stats=dataclasses.asdict(p.stats()),
                pins={k: sorted(v) for k, v in p._pin_pages.items()},
                index=dict(p.prefix_index))


class _Pagers:
    """A port pager and a reference pager; `call` runs one method on both
    and checks the results and the states equal. Records returned by one
    side are passed back to the same side."""

    def __init__(self, num_pages=17, page_size=4, num_slots=2,
                 pages_per_slot=6):
        self.p = [kv.KVPager(kv.PagerConfig(
            num_pages=num_pages, page_size=page_size, num_slots=num_slots,
            pages_per_slot=pages_per_slot)) for kv in (tkv, jkv)]

    def call(self, name, *args, **kw):
        out = []
        for i, pager in enumerate(self.p):
            a = [x[i] if isinstance(x, _Both) else x for x in args]
            k = {n: x[i] if isinstance(x, _Both) else x
                 for n, x in kw.items()}
            out.append(getattr(pager, name)(*a, **k))
        assert _pager_state(self.p[0]) == _pager_state(self.p[1])
        self.p[0].verify_invariants()
        if name == "export_slot":
            assert out[0][1] == out[1][1]
            assert dataclasses.asdict(out[0][0]) == \
                dataclasses.asdict(out[1][0])
            return _Both(o[0] for o in out), out[0][1]
        assert out[0] == out[1], name
        return out[0]

    def raises(self, exc_name, name, *args, **kw):
        for i, (kv, pager) in enumerate(zip((tkv, jkv), self.p)):
            a = [x[i] if isinstance(x, _Both) else x for x in args]
            with pytest.raises(getattr(kv, exc_name)):
                getattr(pager, name)(*a, **kw)
        assert _pager_state(self.p[0]) == _pager_state(self.p[1])

    @property
    def port(self):
        return self.p[0]


class _Both(tuple):
    """One value per side (port, reference)."""


def test_export_adopt_accounting_roundtrip():
    src, dst = _Pagers(), _Pagers()
    slot, pages = src.call("alloc_slot", prompt_len=10, max_new_tokens=5)
    src.call("commit_chunk", slot, 0, 10)
    rec, phys = src.call("export_slot", slot)
    assert phys == pages and rec[0].n_pages == 3
    assert rec[0].slot_len == 10 and rec[0].committed == 10
    dslot, scatter = dst.call("adopt", rec, max_new_tokens=5)
    assert [i for i, _ in scatter] == [0, 1, 2]
    assert dst.port.slot_committed[dslot] == 10
    assert dst.port.slot_reserved[dslot] == 1
    src.call("free_slot", slot)
    dst.call("extend", dslot, 14)


def test_adopt_rejects_without_mutation_then_retries():
    src, dst = _Pagers(), _Pagers(num_pages=4)
    slot, _ = src.call("alloc_slot", prompt_len=10, max_new_tokens=8)
    src.call("commit_chunk", slot, 0, 10)
    rec, _ = src.call("export_slot", slot)
    before = _pager_state(dst.port)
    dst.raises("PageAllocationError", "adopt", rec, max_new_tokens=8)
    assert _pager_state(dst.port) == before
    assert not dst.call("can_adopt", rec, max_new_tokens=8)
    assert dst.call("can_adopt", rec, max_new_tokens=1)
    _, scatter = dst.call("adopt", rec, max_new_tokens=1)
    assert len(scatter) == 3


def test_adopt_aliases_prefix_pages_and_registers_once():
    toks = np.arange(12, dtype=np.int32)
    src, dst = _Pagers(), _Pagers()
    s1, _ = src.call("alloc_slot", prompt_len=12, max_new_tokens=3)
    src.call("commit_chunk", s1, 0, 12)
    src.call("register_prefix", s1, toks, "sys")
    rec1, _ = src.call("export_slot", s1)
    assert all(m is not None for m in rec1[0].page_meta)
    d1, sc1 = dst.call("adopt", rec1, max_new_tokens=3)
    assert len(sc1) == 3 and len(dst.port.prefix_index) == 3
    used = dst.port.pages_in_use
    d2, sc2 = dst.call("adopt", rec1, max_new_tokens=3)
    assert sc2 == [] and len(dst.port.prefix_index) == 3
    assert dst.port.pages_in_use == used
    assert all(int(dst.port.page_ref[pg]) == 2
               for pg in dst.port.slot_pages[d2])
    dst.call("free_slot", d1)
    dst.call("free_slot", d2)


def test_adopt_joins_decode_side_pin():
    toks = np.arange(8, dtype=np.int32)
    src, dst = _Pagers(), _Pagers()
    dst.call("pin_prefix", "sys")
    s1, _ = src.call("alloc_slot", prompt_len=8, max_new_tokens=2)
    src.call("commit_chunk", s1, 0, 8)
    src.call("register_prefix", s1, toks, "sys")
    rec, _ = src.call("export_slot", s1)
    dslot, scatter = dst.call("adopt", rec, max_new_tokens=2)
    assert len(scatter) == 2
    dst.call("free_slot", dslot)
    assert len(dst.port.prefix_index) == 2
    assert dst.call("unpin_prefix", "sys") == 2
    assert dst.port.pages_in_use == 0


# ---------------------------------------------------------------------------
# Engine-level: the wire image's layout and bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jm = jbuild(jconfigs.get_smoke_config("qwen25-05b"))
    tm = Model(qwen25_05b.smoke_config())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


_KW = dict(max_seq=64, num_slots=2, page_size=8, prefill_chunk=8)


def _one_handoff(mod, m, params, prompt, max_new=6, **kw):
    """Drive a PrefillEngine to the park point and wire the handoff."""
    pe = mod.PrefillEngine(m, params, **{**_KW, **kw})
    rid = pe.submit(prompt, max_new)
    sched = pe.engine._scheduler
    for _ in range(64):
        pe.step()
        if sched.ready_handoffs:
            break
    pe.exported = list(sched.pager.slot_pages[sched.ready_handoffs[0][1]])
    hs = pe.collect_handoffs()
    assert len(hs) == 1 and hs[0].request.rid == rid
    return pe, pe.wire(hs[0])


def _pool_pages(engine, ids) -> dict:
    """{seg: {leaf: [L, n, ...] raw bytes}} of pages ``ids`` of a port
    engine's pools."""
    return {seg: {k: _raw(torch.stack([e["kv_pool"][k][ids]
                                       for e in layers]).view(torch.uint8))
                  for k in layers[0]["kv_pool"]}
            for seg, layers in engine._paged_cache.items()}


def _raw(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_handoff_wire_equals_reference_and_adopts_byte_exact(pair,
                                                             kv_quant):
    """13 tokens over 2 pages of 8 (the tail page partly filled): the
    port's wire image has the JAX prefill engine's layout — the same
    leaves (codes and ks/vs strips for int8), shapes and item sizes — so
    ``wire_bytes`` are equal. Its bytes are the prefill pool's pages
    exactly, and after adopt the decode pool's pages hold exactly those
    bytes again; the request then decodes on. (The values themselves
    differ from JAX's where the frameworks round K/V differently.)"""
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tm.cfg.vocab_size, 13).astype(np.int32)
    pe, h = _one_handoff(tdisagg, tm, tp, prompt, kv_quant=kv_quant)
    _, jh = _one_handoff(jdisagg, jm, jp, prompt, kv_quant=kv_quant)
    assert h.record.slot_len == 13 and h.record.committed == 13
    assert h.record.n_pages == jh.record.n_pages == 2
    assert h.wire_bytes == jh.wire_bytes > 0
    assert {s: sorted(d) for s, d in h.strips.items()} == \
        {s: sorted(d) for s, d in jh.strips.items()}
    if kv_quant == "int8":
        assert {"k", "v", "ks", "vs"} == set(h.strips["seg_0"])
    src = _pool_pages(pe.engine, pe.exported)
    for seg, leaves in h.strips.items():
        for k, a in leaves.items():
            ja = np.asarray(jh.strips[seg][k])
            assert (a.shape, a.itemsize) == (ja.shape, ja.itemsize), k
            np.testing.assert_array_equal(_raw(a), src[seg][k],
                                          err_msg=f"{seg}/{k}")
    de = tdisagg.DecodeEngine(tm, tp, **{**_KW, "kv_quant": kv_quant})
    drid, n_fresh = de.adopt(h)
    assert n_fresh == 2
    sched = de.engine._scheduler
    (dslot,) = sched.slots
    back, wire = de.engine.handoff_wire(
        de.engine.handoff_gather(sched.pager.slot_pages[dslot]))
    assert wire == h.wire_bytes
    for seg, leaves in h.strips.items():
        for k, a in leaves.items():
            np.testing.assert_array_equal(_raw(back[seg][k]), _raw(a))
    sched.pager.verify_invariants()
    assert len(de.engine.drain()[drid]) == 6


def test_handoff_wire_bytes_int8_half(pair):
    _, tm, _, tp = pair
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, tm.cfg.vocab_size, 24).astype(np.int32)
    _, h_fp = _one_handoff(tdisagg, tm, tp, prompt, kv_quant=None)
    _, h_q = _one_handoff(tdisagg, tm, tp, prompt, kv_quant="int8")
    assert h_fp.wire_bytes > 0 and h_q.wire_bytes > 0
    assert h_q.wire_bytes / h_fp.wire_bytes < 0.6


def test_adopt_requires_wired_handoff(pair):
    _, tm, _, tp = pair
    pe = tdisagg.PrefillEngine(tm, tp, **_KW)
    pe.submit(np.arange(9, dtype=np.int32), 4)
    sched = pe.engine._scheduler
    for _ in range(64):
        pe.step()
        if sched.ready_handoffs:
            break
    (h,) = pe.collect_handoffs()
    with pytest.raises(ValueError, match="not wired"):
        tdisagg.DecodeEngine(tm, tp, **_KW).adopt(h)


def test_meshes_are_not_ported(pair):
    """Per-side meshes are ported: a prefill mesh of 2 and a decode mesh
    of 4 (shards sharing the CPU) serve the unified engine's streams with
    the unsharded pair's wire bytes, `ReplicaSpec` builds such a pair from
    its widths, and the smoke config's one kv head refuses a 2-way mesh
    on either side with the reference's error. The whole mesh matrix:
    `tests/test_torch_tp_serving.py`."""
    _, tm, _, tp = pair
    cfg = dataclasses.replace(tm.cfg, num_heads=8, num_kv_heads=4,
                              head_dim=16)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = np.arange(13, dtype=np.int32) + 5
    ref = _unified_streams(m, p, [prompt], 6, None, kv_quant="int8")
    wires = []
    for pm, dm in ((None, None), (2, 4)):
        ctrl, got = _controller_run(
            tdisagg, m, p, [prompt], 6, None, handoff_min_tokens=1,
            kv_quant="int8",
            prefill_mesh=pm and serving_mesh(pm, devices=["cpu"] * pm),
            decode_mesh=dm and serving_mesh(dm, devices=["cpu"] * dm))
        assert got == ref and ctrl.stats().handoffs == 1
        wires.append(ctrl.stats().wire_bytes)
    assert wires[0] == wires[1] > 0
    ctrl = ReplicaSpec(disagg=True, prefill_mesh_axis=2, decode_mesh_axis=4,
                       engine_kwargs=dict(_KW, handoff_min_tokens=1)
                       ).build(m, p)
    assert ctrl.decode.stats().model_axis == 4
    for kw in (dict(prefill_mesh_axis=2), dict(decode_mesh_axis=2)):
        with pytest.raises(ValueError, match="num_kv_heads=1"):
            ReplicaSpec(disagg=True, engine_kwargs=_KW, **kw).build(tm, tp)


# ---------------------------------------------------------------------------
# Controller: streams ≡ unified, DisaggStats ≡ the reference controller's
# ---------------------------------------------------------------------------

_STAT_INTS = ("handoffs", "direct", "handoff_pages", "aliased_pages",
              "wire_bytes")


def _unified_streams(m, params, prompts, max_new, prefix_id, **feats):
    eng = GenerationEngine(m, params, **{**_KW, **feats})
    rids = [eng.submit(p, max_new, prefix_id=prefix_id) for p in prompts]
    out = eng.drain()
    return [out[r].tolist() for r in rids]


def _controller_run(mod, m, params, prompts, max_new, prefix_id, **kw):
    ctrl = mod.DisaggController(m, params, **{**_KW, **kw})
    crids = [ctrl.submit(p, max_new, prefix_id=prefix_id) for p in prompts]
    out = ctrl.drain()
    return ctrl, [out[r].tolist() for r in crids]


@pytest.mark.parametrize("feats", [dict(), dict(kv_quant="int8")],
                         ids=["plain", "int8_prefix"])
def test_controller_streams_identical_to_unified(pair, feats):
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(8)
    prefix_id = "sys" if feats else None
    prefix = rng.integers(0, tm.cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, tm.cfg.vocab_size, t).astype(np.int32)]) for t in (5, 12, 9)]
    ref = _unified_streams(tm, tp, prompts, 8, prefix_id, **feats)
    ctrl, got = _controller_run(tdisagg, tm, tp, prompts, 8, prefix_id,
                                handoff_min_tokens=1, **feats)
    assert got == ref, "disagg streams diverged from unified"
    jctrl, _ = _controller_run(jdisagg, jm, jp, prompts, 8, prefix_id,
                               handoff_min_tokens=1, **feats)
    st, jst = ctrl.stats(), jctrl.stats()
    assert {k: getattr(st, k) for k in _STAT_INTS} == \
        {k: getattr(jst, k) for k in _STAT_INTS}
    assert st.handoffs == len(prompts) and st.direct == 0
    assert st.wire_bytes > 0 and st.adopt_time_s > 0.0
    assert (st.aliased_pages > 0) == (prefix_id is not None)
    for side in (ctrl.prefill.engine, ctrl.decode.engine):
        side._scheduler.pager.verify_invariants()
        assert side._scheduler.pager.pages_in_use == 0


def test_controller_routing_threshold(pair):
    """Prompts under the threshold are served whole by the decode engine;
    past it they take the handoff path; ``max_new_tokens == 1`` never
    hands off. Streams match the unified engine either way, the stats
    the reference controller's."""
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(9)
    short = rng.integers(0, tm.cfg.vocab_size, 6).astype(np.int32)
    long_ = rng.integers(0, tm.cfg.vocab_size, 24).astype(np.int32)
    ref = _unified_streams(tm, tp, [short, long_], 6, None)
    ctrls = []
    for mod, m, p in ((tdisagg, tm, tp), (jdisagg, jm, jp)):
        ctrl = mod.DisaggController(m, p, handoff_min_tokens=16, **_KW)
        crids = [ctrl.submit(q, 6) for q in (short, long_)]
        out = ctrl.drain()
        crid = ctrl.submit(long_, 1)
        one = ctrl.drain()
        ctrls.append((ctrl, [out[r].tolist() for r in crids], one[crid]))
    (ctrl, got, one), (jctrl, _, jone) = ctrls
    assert got == ref and len(one) == 1
    st = ctrl.stats()
    assert (st.direct, st.handoffs) == (2, 1)
    assert {k: getattr(st, k) for k in _STAT_INTS} == \
        {k: getattr(jctrl.stats(), k) for k in _STAT_INTS}


def test_controller_auto_threshold_hands_nothing_off_at_h100_constants(
        pair):
    """``handoff_min_tokens="auto"`` reads the split report; at the smoke
    shape and the port's card constants it hands nothing off (decode
    is not memory-bound against compute-bound prefill), so every request
    is served whole by the decode side."""
    _, tm, _, tp = pair
    ctrl = tdisagg.DisaggController(tm, tp, **_KW)
    rep = ctrl.split_report
    assert rep is not None and "crossover_prompt_tokens" in rep
    assert rep["prefill_bound"] in ("compute", "memory")
    assert rep["decode_bound"] in ("compute", "memory")
    assert rep["machine_balance"] == tcost.PEAK_FLOPS / tcost.HBM_BW
    if not rep["disaggregate"]:
        assert ctrl.handoff_min_tokens == _KW["max_seq"] + 1
    ctrl.submit(np.arange(30, dtype=np.int32), 4)
    ctrl.drain()
    assert ctrl.stats().handoffs == 0 or rep["disaggregate"]


def test_controller_in_a_router_fleet(pair):
    """Two disagg replicas behind the Router: placement scores read each
    pair's per-side stats, and every request drains."""
    _, tm, _, tp = pair
    spec = ReplicaSpec(disagg=True, engine_kwargs=dict(
        _KW, handoff_min_tokens=8))
    router = Router([spec.build(tm, tp) for _ in range(2)])
    assert router.warmup() > 0
    rids = [router.submit(np.arange(n, dtype=np.int32) + 3, 4)
            for n in (5, 12, 20)]
    out = router.drain()
    assert sorted(out) == sorted(rids)
    assert all(len(out[r]) == 4 for r in rids)
    st = router.stats()
    assert sum(s.handoffs for s in st) == 2
    assert sum(s.direct for s in st) == 1


# ---------------------------------------------------------------------------
# Costmodel: the split policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
def test_cell_costs_equal_reference(size):
    get = {"full": (jconfigs.get_config, tconfigs.get_config),
           "smoke": (jconfigs.get_smoke_config,
                     tconfigs.get_smoke_config)}[size]
    jcfg, tcfg = (g("qwen25-05b") for g in get)
    for quant in (False, True):
        for step, s, b in (("prefill", 200, 1), ("prefill", 4096, 1),
                           ("decode", 512, 4), ("decode", 4096, 128)):
            a = jcost.cell_costs(jcfg, jcost.serving_cell(step, s, b), quant)
            c = tcost.cell_costs(tcfg, tcost.serving_cell(step, s, b), quant)
            assert a.opt_bytes == 0.0              # no training cells
            assert dataclasses.asdict(c) == {
                k: getattr(a, k) for k in dataclasses.asdict(c)}
            assert c.total_bytes == a.total_bytes


def test_cell_costs_raises_outside_the_registered_kinds():
    """An encoder's decode cell raises (the reference's registry skips
    it: no decode step); a train cell prices as the reference's; a plain
    MLP (hubert-xlarge's kind) prices its two linears as the reference
    does, never as a GLU's three."""
    cfg = tconfigs.get_smoke_config("qwen25-05b")
    c = tcost.cell_costs(cfg, tcost.serving_cell("train", 64), False)
    a = jcost.cell_costs(jconfigs.get_smoke_config("qwen25-05b"),
                         jcost.serving_cell("train", 64), False)
    assert dataclasses.asdict(c) == {k: getattr(a, k)
                                     for k in dataclasses.asdict(c)}
    plain = dataclasses.replace(cfg, mlp_type="plain")
    jplain = dataclasses.replace(jconfigs.get_smoke_config("qwen25-05b"),
                                 mlp_type="plain")
    cell = ("decode", 64, 1)
    c = tcost.cell_costs(plain, tcost.serving_cell(*cell), False)
    a = jcost.cell_costs(jplain, jcost.serving_cell(*cell), False)
    assert dataclasses.asdict(c) == {k: getattr(a, k)
                                     for k in dataclasses.asdict(c)}
    assert c.flops < tcost.cell_costs(cfg, tcost.serving_cell(*cell),
                                      False).flops
    encoder = tconfigs.get_smoke_config("hubert-xlarge")
    with pytest.raises(ValueError, match="no autoregressive decode step"):
        tcost.cell_costs(encoder, tcost.serving_cell("decode", 64), False)


@pytest.mark.parametrize("kw", [dict(decode_batch=128, context=4096),
                                dict(decode_batch=4, context=512,
                                     quant=True),
                                dict(decode_batch=4, context=288)])
def test_disagg_report_equals_reference_under_its_constants(monkeypatch,
                                                            kw):
    monkeypatch.setattr(tcost, "PEAK_FLOPS", 197e12)
    monkeypatch.setattr(tcost, "HBM_BW", 819e9)
    jrep = jcost.disagg_report(jconfigs.get_config("qwen25-05b"), **kw)
    rep = tcost.disagg_report(tconfigs.get_config("qwen25-05b"), **kw)
    assert rep == jrep


def test_disagg_report_h100_constants():
    """At the card's constants decode at batch stays memory-bound and
    prefill runs at far higher intensity; at (batch 4, context 512, int8)
    the report no longer says to disaggregate, where the reference's TPU
    constants do."""
    cfg = tconfigs.get_config("qwen25-05b")
    rep = tcost.disagg_report(cfg, decode_batch=128, context=4096)
    assert rep["decode_bound"] == "memory"
    assert rep["prefill_intensity"] > 4 * rep["decode_intensity"]
    assert rep["disaggregate"] == (rep["prefill_bound"] == "compute"
                                   and rep["decode_bound"] == "memory")
    small = tcost.disagg_report(cfg, decode_batch=4, context=512, quant=True)
    assert not small["disaggregate"]
    assert small["crossover_prompt_tokens"] == 32
    assert jcost.disagg_report(jconfigs.get_config("qwen25-05b"),
                               decode_batch=4, context=512,
                               quant=True)["disaggregate"]
