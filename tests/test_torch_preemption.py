"""SLO preemption, the host KV tier and optimistic admission in the port,
held against the JAX package.

  * scheduler — the port's `Scheduler` and the reference's run side by
    side over a deterministic token chain (the next token is a pure
    function of the previous token and its position, so every
    interleaving is comparable to an uninterrupted stream): after every
    call the events, every integer counter, the pager state, the slots,
    the parked requests and the queue must be equal. The cases are the
    reference's `tests/test_preemption.py` ones that need no speculation
    and no mesh.
  * engine — the port's `GenerationEngine` and the JAX engine on the same
    bridged smoke weights, under reserved and optimistic admission over
    bf16 and int8 pools: the same submits, then `step()` in lockstep with
    the `stats()` integers and the pager state equal after every step
    (``eos_id = -1``, so the schedule does not depend on token values).
    The port's preempted streams must equal the same requests served
    alone by an uninterrupted port engine, and `generate()` for float KV.
  * host tier — a spill then a restore gives back the pages' bytes
    exactly (int8 codes and scale strips, or bf16 words).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro.serving import GenerationEngine as JEngine
from repro.serving import kv_pager as jkv
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import qwen25_05b
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.models.model import Model
from repro_torch.serving import kv_pager as tkv
from repro_torch.serving import scheduler as tsched
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


# ---------------------------------------------------------------------------
# Deterministic-chain executor (the reference's `_ChainExec`, no drafts)
# ---------------------------------------------------------------------------

def _chain(tok: int, pos: int) -> int:
    return (tok * 7 + pos) % 1000 + 1


def _ref_stream(prompt: np.ndarray, max_new: int) -> list[int]:
    """The uninterrupted sequential greedy stream of the chain model."""
    out, last, q = [], int(prompt[-1]), len(prompt) - 1
    for _ in range(max_new):
        last = _chain(last, q)
        out.append(last)
        q += 1
    return out


def _run_chain(tokens, pos, row_slots, sample_idx, temps, topks):
    return np.array([_chain(int(tokens[r, i]), int(pos[r, i]))
                     for r, i in enumerate(sample_idx)], np.int32)


def _prompt(rid: int, n: int) -> np.ndarray:
    return ((np.arange(n) * 13 + rid * 101) % 900 + 1).astype(np.int32)


def _pager_state(p):
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free_pages=list(p.free_pages), free_slots=list(p.free_slots),
                slot_pages={k: list(v) for k, v in p.slot_pages.items()},
                slot_len=p.slot_len.tolist(), reserved=dict(p.slot_reserved),
                committed=dict(p.slot_committed), version=p.version,
                stats=dataclasses.asdict(p.stats()),
                spills={i: (r.layout, r.spilled_pages, r.slot_len,
                            r.committed, r.reserved)
                        for i, r in p.spill_records.items()})


def _int_stats(st) -> dict:
    """Every counter of a `SchedulerStats` but the wall-clock one."""
    d = dataclasses.asdict(st)
    d.pop("restore_time_s")
    return d


class _Twin:
    """The port's scheduler and the reference's over the same pager
    shape and chain executor; every forwarded call must return the same
    and leave both in the same state."""

    def __init__(self, num_slots=2, pages_per_slot=4, page_size=4,
                 num_pages=9, optimistic=False, chunk=4, preemption=True,
                 **kw):
        self.pair = []
        for kv, sc in ((tkv, tsched), (jkv, jsched)):
            pager = kv.KVPager(kv.PagerConfig(
                num_pages=num_pages, page_size=page_size,
                num_slots=num_slots, pages_per_slot=pages_per_slot,
                optimistic=optimistic))
            self.pair.append(sc.Scheduler(pager, run_batch=_run_chain,
                                          chunk_size=chunk,
                                          preemption=preemption, **kw))
        self.port, self.ref = self.pair

    def submit(self, rid, n, max_new, priority=0):
        for sc, s in zip((tsched, jsched), self.pair):
            s.submit(sc.Request(rid=rid, tokens=_prompt(rid, n),
                                max_new_tokens=max_new, priority=priority))
        self.check()

    def call(self, name, *args, **kw):
        got = [getattr(s, name)(*args, **kw) for s in self.pair]
        assert got[0] == got[1], name
        self.check()
        return got[0]

    def run(self) -> dict:
        steps = 0
        while not self.ref.idle:
            self.call("step")
            steps += 1
            assert steps < 1000
        assert self.port.idle
        out = [s.run() for s in self.pair]
        out = [{**dict(s.finished), **o} for s, o in zip(self.pair, out)]
        for s, o in zip(self.pair, out):
            s.finished.clear()
        assert {r: t.tolist() for r, t in out[0].items()} == \
            {r: t.tolist() for r, t in out[1].items()}
        return out[0]

    def check(self):
        p, r = self.pair
        assert _int_stats(p.stats) == _int_stats(r.stats)
        assert _pager_state(p.pager) == _pager_state(r.pager)
        for attr in ("queue", "slots", "preempted"):
            assert self._view(getattr(p, attr)) == \
                self._view(getattr(r, attr)), attr
        p.pager.verify_invariants()

    @staticmethod
    def _view(v):
        if isinstance(v, dict):       # slot → state
            return {s: (st.request.rid, list(st.generated), st.committed)
                    for s, st in v.items()}
        return [(x.state.request.rid, x.seq, x.record.spill_id,
                 list(x.state.generated), x.state.committed)
                if hasattr(x, "state") else x.rid for x in v]

    @property
    def slot_of(self):
        return {st.request.rid: s for s, st in self.port.slots.items()}


def _assert_drained(sched):
    assert sched.pager.pages_in_use == 0
    assert sched.pager._reserved == 0
    assert not sched.pager.spill_records
    assert not sched.preempted


# ---------------------------------------------------------------------------
# Scheduler: priority admission, organic preemption, pressure relief
# ---------------------------------------------------------------------------

def test_priority_orders_queue_fifo_within_class():
    tw = _Twin(num_pages=99)
    for rid, pri in [(0, 0), (1, 2), (2, 1), (3, 2)]:
        tw.submit(rid, 4, 2, priority=pri)
    assert [r.rid for r in tw.port.queue] == [1, 3, 2, 0]


def test_high_priority_preempts_and_all_streams_identical():
    """2 slots / 8 usable pages held by low-priority requests; two
    high-priority arrivals evict them via spill, and every stream
    matches its uninterrupted chain reference."""
    tw = _Twin()
    for r in (0, 1):
        tw.submit(r, 4, 12, priority=0)       # 15 tokens → 4 pages each
    for _ in range(3):
        tw.call("step")
    for r in (2, 3):
        tw.submit(r, 4, 4, priority=1)
    out = tw.run()
    st = tw.port.stats
    assert st.preemptions >= 2
    assert st.restores == st.preemptions
    assert st.spilled_pages == st.restored_pages > 0
    for r, new in ((0, 12), (1, 12), (2, 4), (3, 4)):
        assert list(out[r]) == _ref_stream(_prompt(r, 4), new), r
    assert st.prefill_tokens == 16            # zero recompute
    _assert_drained(tw.port)


def test_victim_selection_lowest_class_most_pages_least_progress():
    tw = _Twin(num_slots=3, num_pages=99)
    tw.submit(0, 12, 4, priority=0)           # 3 pages
    tw.submit(1, 4, 4, priority=0)            # 1 page
    tw.submit(2, 4, 4, priority=1)
    tw.call("step")
    assert tw.call("_pick_victim", below=2) == tw.slot_of[0]
    assert tw.call("_pick_victim", below=0) is None


def test_victim_tiebreak_least_progress():
    tw = _Twin(num_pages=99)
    tw.submit(0, 4, 10)                       # 1/10 done after a step
    tw.submit(1, 4, 2)                        # 1/2 done
    tw.call("step")
    assert all(len(st.generated) == 1 for st in tw.port.slots.values())
    assert tw.call("_pick_victim", below=1) == tw.slot_of[0]


def test_restore_preferred_over_queue_within_class():
    tw = _Twin(num_slots=1, num_pages=5)
    tw.submit(0, 4, 12)
    for _ in range(2):
        tw.call("step")
    assert tw.call("preempt_request", 0)
    tw.submit(1, 4, 2)
    tw.call("step")
    assert [st.request.rid for st in tw.port.slots.values()] == [0]
    assert [r.rid for r in tw.port.queue] == [1]
    out = tw.run()
    assert list(out[0]) == _ref_stream(_prompt(0, 4), 12)
    assert list(out[1]) == _ref_stream(_prompt(1, 4), 2)
    _assert_drained(tw.port)


def test_preempt_between_prefill_chunks_resumes_at_watermark():
    tw = _Twin(num_slots=1, pages_per_slot=8, num_pages=17)
    tw.submit(0, 24, 4)
    tw.call("step")                           # chunked prefill begins
    (st,) = tw.port.slots.values()
    assert 0 < st.committed < 24
    assert tw.call("preempt_request", 0)
    out = tw.run()
    assert list(out[0]) == _ref_stream(_prompt(0, 24), 4)
    assert tw.port.stats.prefill_tokens == 24     # no chunk ran twice
    assert tw.port.stats.preemptions == tw.port.stats.restores == 1
    _assert_drained(tw.port)


def test_optimistic_admission_completes_under_pressure():
    """30 pages of worst-case demand in a 12-usable-page pool: optimistic
    admits all three and spills under pressure."""
    tw = _Twin(num_slots=3, pages_per_slot=10, num_pages=13,
               optimistic=True)
    for r in range(3):
        tw.submit(r, 4, 37)                   # 40 tokens → 10 pages each
    tw.call("step")
    assert tw.port.num_active == 3
    out = tw.run()
    assert tw.port.stats.pressure_spills > 0
    for r in range(3):
        assert list(out[r]) == _ref_stream(_prompt(r, 4), 37)
    _assert_drained(tw.port)


def test_reserved_admission_serializes_same_load():
    tw = _Twin(num_slots=3, pages_per_slot=10, num_pages=13,
               preemption=False)
    for r in range(3):
        tw.submit(r, 4, 37)
    tw.call("step")
    assert tw.port.num_active == 1
    out = tw.run()
    assert tw.port.stats.preemptions == 0
    for r in range(3):
        assert list(out[r]) == _ref_stream(_prompt(r, 4), 37)


def test_manual_preempt_hook_edge_cases():
    tw = _Twin(num_pages=99)
    tw.submit(0, 4, 4)
    tw.call("step")
    assert not tw.call("preempt_request", 77)     # unknown rid
    no_pre = _Twin(num_pages=99, preemption=False)
    with pytest.raises(ValueError, match="preemption"):
        no_pre.port.preempt_request(0)
    with pytest.raises(ValueError, match="optimistic"):
        _Twin(optimistic=True, preemption=False)
    pager = tkv.KVPager(tkv.PagerConfig(num_pages=9, page_size=4,
                                        num_slots=2, pages_per_slot=4))
    with pytest.raises(ValueError, match="chunked"):
        tsched.Scheduler(pager, prefill_commit=lambda *a: 0,
                         decode=lambda *a: 0, preemption=True)
    # spill_fn sees exactly the pages the pager then spills
    seen = {}
    tw2 = _Twin(num_pages=99,
                spill_fn=lambda ids: seen.setdefault("ids", list(ids)),
                restore_fn=lambda h, fresh: seen.setdefault("fresh",
                                                            list(fresh)))
    tw2.submit(0, 6, 8)
    for _ in range(3):
        tw2.call("step")
    assert tw2.call("preempt_request", 0)
    assert seen["ids"] == tw2.port.preempted[0].record.spilled_pages
    tw2.run()
    assert len(seen["fresh"]) == len(seen["ids"])


def test_run_raises_when_parked_request_can_never_be_placed():
    tw = _Twin()
    state = tsched._SlotState(request=tsched.Request(
        rid=9, tokens=_prompt(9, 4), max_new_tokens=4),
        generated=[5], committed=4)
    rec = tkv.SpillRecord(spill_id=123, layout=[("spilled", 0)],
                          spilled_pages=[7], slot_len=5, committed=4,
                          reserved=0)
    tw.port.preempted.append(tsched._Preempted(state=state, record=rec,
                                               handle=None, seq=0))
    with pytest.raises(RuntimeError, match="wedged"):
        tw.port.run()


def test_stats_surface_counts_spill_traffic():
    tw = _Twin()
    for r in (0, 1):
        tw.submit(r, 4, 12)
    for _ in range(3):
        tw.call("step")
    tw.submit(2, 4, 4, priority=1)
    tw.run()
    st = tw.port.stats
    assert st.preemptions >= 1
    assert st.restores == st.preemptions
    assert st.restored_pages == st.spilled_pages >= st.restores
    assert st.restore_time_s > 0.0


# ---------------------------------------------------------------------------
# Engine: the port's host tier against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(jax model, port model, jax params, port params): the reference's
    smoke weights, carried across bit for bit."""
    jm = jbuild(jconfigs.get_smoke_config("qwen25-05b"))
    tm = Model(qwen25_05b.smoke_config())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jm, tm, jp, tp


_KW = dict(max_seq=128, num_slots=2, page_size=8, prefill_chunk=8)


def _engine_snapshot(eng) -> dict:
    st = dataclasses.asdict(eng.stats())
    st.pop("restore_ms_mean")                 # a wall time
    return st


def _lockstep(port, ref, steps=None):
    """Step both engines until the reference idles (or ``steps`` times),
    holding events, `stats()` and the pager state equal."""
    n = 0
    while not ref.idle and (steps is None or n < steps):
        ev_p, ev_r = port.step(), ref.step()
        assert [r for r, _ in ev_p] == [r for r, _ in ev_r]
        assert _engine_snapshot(port) == _engine_snapshot(ref)
        assert _pager_state(port._scheduler.pager) == \
            _pager_state(ref._scheduler.pager)
        n += 1
    return n


def _solo_streams(tm, tp, prompts, max_new, **kw):
    """Uninterrupted references: each request served alone by a port
    engine without preemption and with an ample pool."""
    eng = GenerationEngine(tm, tp, **{**_KW, "num_pages": 64, **kw})
    out = []
    for p in prompts:
        rid = eng.submit(p, max_new)
        out.append(eng.drain()[rid].tolist())
    return out


@pytest.mark.parametrize("admission", ["reserved", "optimistic"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_preemption_matches_jax_and_solo_streams(pair, kv_quant,
                                                        admission):
    """Organic SLO preemption through the port's device movers: two
    long low-priority requests sharing a prefix, then two short
    high-priority ones in a 13-usable-page pool. Every integer equals the
    JAX engine's step for step, and every port stream equals the same
    request served alone."""
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, tm.cfg.vocab_size, 16).astype(np.int32)
    longs = [np.concatenate([prefix, rng.integers(
        0, tm.cfg.vocab_size, t).astype(np.int32)]) for t in (5, 9)]
    shorts = [rng.integers(0, tm.cfg.vocab_size, t).astype(np.int32)
              for t in (6, 4)]
    kw = dict(_KW, num_pages=14, preemption=True, admission=admission,
              kv_quant=kv_quant)
    port, ref = GenerationEngine(tm, tp, **kw), JEngine(jm, jp, **kw)
    lo = [(port.submit(p, 24, prefix_id="sys"),
           ref.submit(p, 24, prefix_id="sys"))[0] for p in longs]
    assert _lockstep(port, ref, steps=4) == 4
    hi = [(port.submit(p, 8, priority=1), ref.submit(p, 8, priority=1))[0]
          for p in shorts]
    _lockstep(port, ref)
    assert port.idle
    out = port.collect()
    st = port.stats()
    assert st.preemptions >= 1 and st.restores == st.preemptions
    assert st.spilled_pages == st.restored_pages > 0
    assert st.pages_spilled_now == 0 and st.pager.pages_used == 0
    assert st.restore_ms_mean > 0.0
    want = (_solo_streams(tm, tp, longs, 24, kv_quant=kv_quant)
            + _solo_streams(tm, tp, shorts, 8, kv_quant=kv_quant))
    assert [out[r].tolist() for r in lo + hi] == want
    if kv_quant == "none":                    # float KV: ≡ generate()
        assert want == [port.generate({"tokens": p[None]}, n)[0].tolist()
                        for p, n in zip(longs + shorts, (24, 24, 8, 8))]


def test_engine_optimistic_pressure_spills_match_jax(pair):
    """Optimistic admission past the pool: three requests whose reserved
    worst case (3 × 7 pages) does not fit 12 usable pages all admit, and
    pressure relief spills; integers equal the JAX engine's."""
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tm.cfg.vocab_size, t).astype(np.int32)
               for t in (12, 9, 14)]
    kw = dict(_KW, max_seq=56, num_slots=3, num_pages=13, preemption=True,
              admission="optimistic", kv_quant="int8")
    port, ref = GenerationEngine(tm, tp, **kw), JEngine(jm, jp, **kw)
    rids = [(port.submit(p, 40), ref.submit(p, 40))[0] for p in prompts]
    _lockstep(port, ref)
    st = port.stats()
    assert st.pressure_spills >= 1 and st.restores == st.preemptions
    out = port.collect()
    assert [out[r].tolist() for r in rids] == _solo_streams(
        tm, tp, prompts, 40, max_seq=56, kv_quant="int8")


def test_engine_manual_preempt_between_chunks(pair):
    """`preempt(rid)` mid-prefill of a 40-token prompt: the restored
    request resumes at the commit watermark (zero recompute), its
    integers equal the JAX engine's and its float-KV stream equals
    `generate()`."""
    jm, tm, jp, tp = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tm.cfg.vocab_size, 40).astype(np.int32)
    kw = dict(_KW, num_pages=32, prefill_chunk=4, preemption=True)
    port, ref = GenerationEngine(tm, tp, **kw), JEngine(jm, jp, **kw)
    rid = port.submit(prompt, 8)
    assert ref.submit(prompt, 8) == rid
    _lockstep(port, ref, steps=1)
    assert port.preempt(rid) and ref.preempt(rid)
    assert not port.preempt(999)
    assert _engine_snapshot(port) == _engine_snapshot(ref)
    _lockstep(port, ref)
    out = port.collect()
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        want = port.generate({"tokens": prompt[None]}, 8)[0]
    np.testing.assert_array_equal(out[rid], want)
    sst = port.scheduler_stats
    assert sst.preemptions == sst.restores == 1
    assert sst.prefill_tokens + sst.prefill_tokens_skipped == 40


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_host_tier_round_trip_is_byte_exact(pair, kv_quant):
    """Spill a decoding slot, then restore it into fresh pages: the
    parked strips hold the pages' bytes as they were, on the host, and
    the fresh pages hold exactly those bytes again (codes and scale
    strips for int8, bf16 words otherwise)."""
    _, tm, _, tp = pair
    eng = GenerationEngine(tm, tp, **_KW, num_pages=32, preemption=True,
                           kv_quant=kv_quant)
    rid = eng.submit(np.arange(21, dtype=np.int32) * 5 % 256, 6)
    for _ in range(3):
        eng.step()
    sched = eng._scheduler
    (slot,) = sched.slots
    ids = sched.pager.peek_spill(slot)
    assert len(ids) == 3
    before = {(seg, k): torch.stack([e["kv_pool"][k][ids] for e in layers])
              for seg, layers in eng._paged_cache.items()
              for k in layers[0]["kv_pool"]}
    assert eng.preempt(rid)
    (parked,) = sched.preempted
    strips = parked.handle["strips"]
    assert set(before) == {(s, k) for s, d in strips.items() for k in d}
    for (seg, k), want in before.items():
        got = strips[seg][k]
        assert got.device.type == "cpu" and got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # let another request take the freed pages, then restore
    assert sched._try_restore(parked)
    (slot2,) = sched.slots
    fresh = [pg for pg in sched.pager.slot_pages[slot2]]
    for (seg, k), want in before.items():
        got = torch.stack([e["kv_pool"][k][fresh]
                           for e in eng._paged_cache[seg]])
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert eng.drain()[rid].shape == (6,)
    assert eng.stats().pages_spilled_now == 0
