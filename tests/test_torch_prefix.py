"""Prefix sharing and pinning in the port, held against the JAX package.

Ports of `tests/test_prefix_sharing.py` and `tests/test_prefix_pinning.py`:

  * pager scenarios run on the port's and the JAX package's pager side by
    side; the reference's assertions must hold on the port's, and the
    two pagers' integer state (tables, refcounts, free lists, pins, the
    prefix index) must be equal at the end;
  * the scheduler's prefix branches (admission match, the "same prefix
    still prefilling" hold, the skip, registration on the final chunk)
    driven through a fake executor on both schedulers: every dispatch
    and every counter must be equal step by step;
  * the engine end to end: greedy shared-prefix streams ≡ unshared
    streams ≡ the port's own `generate()` (JAX streams are not the
    oracle: seven JAX identity tests are red on this tree), and the
    engine's integer state after pinned bursts equal to the JAX
    engine's for the same submits.
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
from repro_torch.configs import qwen25_05b
from repro_torch.core.pipeline import quantize_params
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


KV = {"jax": jkv, "port": tkv}


def _pager(kv, num_pages=17, page_size=4, num_slots=4, pages_per_slot=4):
    return kv.KVPager(kv.PagerConfig(num_pages=num_pages, page_size=page_size,
                                     num_slots=num_slots,
                                     pages_per_slot=pages_per_slot))


def _toks(*vals):
    return np.asarray(vals, np.int32)


def _state(p):
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free_pages=list(p.free_pages), free_slots=list(p.free_slots),
                slot_pages={k: list(v) for k, v in p.slot_pages.items()},
                reserved=dict(p.slot_reserved),
                committed=dict(p.slot_committed),
                stats=dataclasses.asdict(p.stats()),
                pins={k: sorted(v) for k, v in p._pin_pages.items()},
                index=dict(p.prefix_index))


def _both(scenario):
    """Run ``scenario(kv)`` on both pagers; their end states must agree."""
    states = {name: _state(scenario(kv)) for name, kv in KV.items()}
    assert states["port"] == states["jax"]


# ------------------------------------------------------- pager: sharing

def _alias_refcount(kv):
    p = _pager(kv)
    prompt = _toks(*range(10))                  # 2 full pages + 2-token tail
    s_a, pages_a = p.alloc_slot(10, 3)
    p.register_prefix(s_a, prompt, "sys")
    shared = p.match_prefix(prompt, "sys")
    assert shared == pages_a[:2]
    s_b, pages_b = p.alloc_slot(10, 3, shared_pages=shared)
    assert pages_b[:2] == pages_a[:2] and pages_b[2] != pages_a[2]
    assert p.page_ref[pages_a[0]] == 2 and p.page_ref[pages_a[1]] == 2
    assert p.shared_pages == 2
    assert p.pages_in_use == 4 and p.logical_pages_in_use == 6
    free_before = p.num_free_pages
    p.free_slot(s_a)                            # B still holds the prefix
    assert p.page_ref[pages_a[0]] == 1
    assert p.num_free_pages == free_before + 1
    assert p.match_prefix(prompt, "sys") == shared
    p.free_slot(s_b)                            # last owner: freed once
    assert p.pages_in_use == 0 and (p.page_ref == 0).all()
    assert len(set(p.free_pages)) == len(p.free_pages)
    assert not p.prefix_index and p.match_prefix(prompt, "sys") == []
    return p


def _namespaces_and_content(kv):
    p = _pager(kv)
    s_a, _ = p.alloc_slot(8, 2)
    p.register_prefix(s_a, _toks(*range(8)), "alice")
    assert p.match_prefix(_toks(*range(8)), "alice")
    assert p.match_prefix(_toks(*range(8)), "bob") == []
    assert p.match_prefix(_toks(*range(8)), None) == []
    assert p.match_prefix(_toks(*range(1, 9)), "alice") == []
    assert len(p.match_prefix(_toks(0, 1, 2, 3, 9, 9, 9, 9), "alice")) == 1
    s_b, pages_b = p.alloc_slot(6, 2)           # 1 full + 1 partial page
    p.register_prefix(s_b, _toks(*range(6)), "sys")
    assert p.match_prefix(_toks(*range(6)), "sys") == pages_b[:1]
    return p


def _admission_and_private_pages(kv):
    p = _pager(kv, num_pages=6, page_size=4, num_slots=2, pages_per_slot=4)
    prompt = _toks(*range(16))
    s_a, _ = p.alloc_slot(16, 1)
    p.register_prefix(s_a, prompt, "sys")
    assert not p.can_admit(16, 1)
    shared = p.match_prefix(prompt, "sys")
    assert len(shared) == 4 and p.can_admit(16, 1, n_shared=4)
    s_b, _ = p.alloc_slot(16, 1, shared_pages=shared)
    assert p.pages_in_use == 4
    p.free_slot(s_a)
    p.free_slot(s_b)
    q = _pager(kv)
    s_c, pages_c = q.alloc_slot(4, 1)
    with pytest.raises(kv.PageAllocationError):
        q.alloc_slot(8, 2, shared_pages=[pages_c[0], 3])
    assert q.page_ref[pages_c[0]] == 1 and q.page_ref[3] == 0
    s_d, _ = q.alloc_slot(8, 6)
    q.register_prefix(s_d, _toks(*range(8)), "sys")
    q.extend(s_d, 12)
    grown = q.slot_pages[s_d][-1]
    assert q.page_ref[grown] == 1 and grown not in q._page_key
    return q


# -------------------------------------------------------- pager: pinning

def _pin_past_last_owner(kv):
    p = _pager(kv)
    prompt = _toks(*range(10))
    s_a, pages_a = p.alloc_slot(10, 3)
    p.register_prefix(s_a, prompt, "sys")
    assert p.pin_prefix("sys") == 2
    p.free_slot(s_a)
    assert p.match_prefix(prompt, "sys") == pages_a[:2]
    assert p.pages_in_use == 2 and (p.page_ref[pages_a[:2]] == 1).all()
    s_b, pages_b = p.alloc_slot(10, 3, shared_pages=pages_a[:2])
    assert pages_b[:2] == pages_a[:2] and p.slot_committed[s_b] == 8
    p.free_slot(s_b)
    assert p.unpin_prefix("sys") == 2
    assert p.pages_in_use == 0 and not p.prefix_index
    return p


def _pin_sticky_and_namespaced(kv):
    p = _pager(kv)
    assert p.pin_prefix("sys") == 0             # nothing indexed yet
    s_a, pages_a = p.alloc_slot(8, 2)
    p.register_prefix(s_a, _toks(*range(8)), "sys")
    p.free_slot(s_a)                            # the sticky pin holds
    assert p.match_prefix(_toks(*range(8)), "sys") == pages_a[:2]
    s_b, _ = p.alloc_slot(4, 1)
    p.register_prefix(s_b, _toks(*range(4)), "bob")
    p.free_slot(s_b)                            # unpinned: died
    assert p.match_prefix(_toks(*range(4)), "bob") == []
    assert p.unpin_prefix("ghost") == 0
    assert p.unpin_prefix("sys") == 2 and p.unpin_prefix("sys") == 0
    assert p.pages_in_use == 0 and (p.page_ref == 0).all()
    return p


def _pins_count_against_admission(kv):
    p = _pager(kv, num_pages=6, page_size=4, num_slots=2, pages_per_slot=4)
    s_a, _ = p.alloc_slot(8, 1)
    p.register_prefix(s_a, _toks(*range(8)), "sys")
    p.pin_prefix("sys")
    p.free_slot(s_a)
    assert not p.can_admit(12, 2)
    assert p.can_admit(12, 2, n_shared=2)
    return p                                    # left pinned: compared


@pytest.mark.parametrize("scenario", [
    _alias_refcount, _namespaces_and_content, _admission_and_private_pages,
    _pin_past_last_owner, _pin_sticky_and_namespaced,
    _pins_count_against_admission], ids=lambda f: f.__name__.strip("_"))
def test_pager_scenario_matches_jax(scenario):
    _both(scenario)


# ------------------------------------------------ scheduler, fake executor

def _fake_run_batch(tokens, pos, row_slots, sample_idx, temps, topks):
    """Deterministic 'sampling' from the dispatched block alone."""
    return ((tokens.sum(axis=1) * 7 + pos.max(axis=1) + row_slots) % 50
            ).astype(np.int32)


def _schedulers(num_pages=40, page_size=4, num_slots=3, pages_per_slot=8,
                chunk=4):
    out, logs = {}, {}
    for name, (kv, sm) in {"jax": (jkv, jsched), "port": (tkv, tsched)}.items():
        log = logs.setdefault(name, [])

        def run(*a, _log=log):
            _log.append([np.asarray(t).tolist() for t in a])
            return _fake_run_batch(*a)

        pager = _pager(kv, num_pages, page_size, num_slots, pages_per_slot)
        out[name] = sm.Scheduler(pager, run_batch=run, chunk_size=chunk)
    return out, logs


def _counters(st):
    return {f: getattr(st, f) for f in (
        "admitted", "finished", "decode_steps", "slot_tokens", "slot_steps",
        "prefix_shared_pages", "prefill_chunks", "prefill_tokens",
        "prefill_tokens_skipped", "dispatched_positions", "padded_positions")}


def _submit_both(scheds, rid, tokens, new, prefix_id=None, priority=0):
    for name, sm in (("jax", jsched), ("port", tsched)):
        scheds[name].submit(sm.Request(rid=rid, tokens=tokens,
                                       max_new_tokens=new,
                                       prefix_id=prefix_id,
                                       priority=priority))


def _step_both(scheds, logs):
    ev = {n: s.step() for n, s in scheds.items()}
    assert ev["port"] == ev["jax"]
    assert logs["port"] == logs["jax"]
    assert _counters(scheds["port"].stats) == _counters(scheds["jax"].stats)
    assert _state(scheds["port"].pager) == _state(scheds["jax"].pager)
    assert sorted(scheds["port"].slots) == sorted(scheds["jax"].slots)
    return ev["port"]


def test_scheduler_prefix_branches_match_jax():
    """Two namespaces, a follower held while its prefix prefills, a
    fully aliased page-aligned prompt (only its last token runs), a pin
    across bursts and an unshared request: every dispatch, event,
    counter and pager state equal to the JAX scheduler's."""
    scheds, logs = _schedulers()
    rng = np.random.default_rng(0)
    pre = {ns: rng.integers(0, 50, 12).astype(np.int32) for ns in ("a", "b")}
    for s in scheds.values():
        s.pager.pin_prefix("a")
    rid = 0
    for burst in range(2):
        for i in range(5):
            ns = "ab"[i % 2]
            tail = rng.integers(0, 50, int(rng.integers(0, 6))).astype(
                np.int32)
            _submit_both(scheds, rid, np.concatenate([pre[ns], tail]),
                         int(rng.integers(1, 6)), prefix_id=ns)
            rid += 1
        _submit_both(scheds, rid, rng.integers(0, 50, 9).astype(np.int32), 3)
        rid += 1
        steps = 0
        while not scheds["port"].idle:
            _step_both(scheds, logs)
            steps += 1
            assert steps < 500
        assert scheds["jax"].idle
        out = {n: s.run() for n, s in scheds.items()}
        assert out["port"].keys() == out["jax"].keys()
        for r in out["port"]:
            np.testing.assert_array_equal(out["port"][r], out["jax"][r])
    st = scheds["port"].stats
    assert st.prefix_shared_pages > 0 and st.prefill_tokens_skipped > 0
    # only pages indexed under the pinned "a" stay: its 3 prefix pages and
    # any full tail page its prompts registered
    assert scheds["port"].pager.pages_in_use >= 3


def test_scheduler_holds_follower_while_its_prefix_prefills():
    scheds, logs = _schedulers(chunk=4)
    prompt = np.arange(16, dtype=np.int32)
    _submit_both(scheds, 0, prompt, 2, prefix_id="sys")
    _submit_both(scheds, 1, np.concatenate([prompt, [7, 7]]), 2,
                 prefix_id="sys")
    _step_both(scheds, logs)
    # the leader prefills 12 of its 16 tokens in a step of 3 rows × 4; the
    # follower is held, not admitted against a partial (empty) match
    assert list(scheds["port"].queue)[0].rid == 1
    while not scheds["port"].idle:
        _step_both(scheds, logs)
    assert scheds["port"].stats.prefill_tokens_skipped == 16
    assert scheds["port"].stats.prefix_shared_pages == 4


# -------------------------------------------------------- engine end to end

@pytest.fixture(scope="module")
def port_model():
    cfg = qwen25_05b.smoke_config()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, m, quantize_params(p)[0]


def _shared_workload(cfg, prefix_len=16, tail_len=6, n=4, seed=7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (tail_len,)).astype(np.int32)]) for _ in range(n)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_shared_prefix_streams_identical(port_model, kv_quant):
    """shared ≡ unshared ≡ `generate()` (greedy), pages returned once."""
    cfg, m, params = port_model
    prompts = _shared_workload(cfg)
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        runs = {}
        for prefix_id in ("sys", None):
            eng = GenerationEngine(m, params, max_seq=64, num_slots=4,
                                   page_size=8, kv_quant=kv_quant)
            rids = [eng.submit(p, 8, prefix_id=prefix_id) for p in prompts]
            out = eng.drain()
            runs[prefix_id] = [list(out[r]) for r in rids]
            pager = eng._scheduler.pager
            assert pager.pages_in_use == 0 and (pager.page_ref == 0).all()
            shared = eng.stats().prefix_shared_pages
            assert (shared > 0) == (prefix_id is not None)
        assert runs["sys"] == runs[None]
        if kv_quant == "none":
            for p, toks in zip(prompts, runs["sys"]):
                np.testing.assert_array_equal(
                    toks, eng.generate({"tokens": p[None]}, 8)[0])


def test_sharing_raises_concurrency_at_fixed_budget(port_model):
    cfg, m, params = port_model
    prompts = _shared_workload(cfg, prefix_len=16, tail_len=6, n=4)

    def peak_active(prefix_id):
        eng = GenerationEngine(m, params, max_seq=32, num_slots=4,
                               page_size=8, num_pages=12)
        for p in prompts:
            eng.submit(p, 8, prefix_id=prefix_id)
        peak = 0
        while not eng.idle:
            eng.step()
            peak = max(peak, eng.num_active)
        return peak

    assert peak_active(None) <= 2
    assert peak_active("sys") == 4


def _engine_state(eng):
    st = eng.stats()
    pager = eng._scheduler.pager
    return dict(dispatches=st.dispatches, prefill_tokens=st.prefill_tokens,
                skipped=st.prefill_tokens_skipped,
                shared=st.prefix_shared_pages,
                queue_depth=st.queue_depth,
                headroom=st.admission_headroom,
                pager=_state(pager))


def test_pin_skips_prefill_across_bursts_like_jax(port_model):
    """The reference's cross-burst pin test on the port, with the JAX
    engine driven through the same submits: integer state equal after
    each burst; the pinned streams equal a cold unpinned engine's."""
    cfg, m, params = port_model
    jcfg = jconfigs.get_smoke_config("qwen25-05b")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32)
    kw = dict(max_seq=64, num_slots=4, page_size=8, prefill_chunk=8)
    engines = {"port": GenerationEngine(m, params, **kw),
               "jax": JEngine(jm, jp, **kw)}

    def burst(eng, seed):
        r = np.random.default_rng(seed)
        prompts = [np.concatenate([prefix, r.integers(
            0, cfg.vocab_size, (5,)).astype(np.int32)]) for _ in range(3)]
        rids = [eng.submit(p, 4, prefix_id="sys") for p in prompts]
        out = eng.drain()
        return [list(out[r_]) for r_ in rids], prompts

    for eng in engines.values():
        assert eng.pin_prefix("sys") == 0
    for seed in (0, 1):
        skipped = {n: e.stats().prefill_tokens_skipped
                   for n, e in engines.items()}
        res = {n: burst(e, seed) for n, e in engines.items()}
        states = {n: _engine_state(e) for n, e in engines.items()}
        assert states["port"] == states["jax"]
        assert engines["port"]._scheduler.pager.pages_in_use == 2
    gained = engines["port"].stats().prefill_tokens_skipped - skipped["port"]
    assert gained == 3 * 16                     # every request, whole prefix
    streams, prompts = res["port"]
    cold = GenerationEngine(m, params, **kw)
    rids = [cold.submit(p, 4) for p in prompts]
    ref = cold.drain()
    assert streams == [list(ref[r_]) for r_ in rids]
    for eng in engines.values():
        assert eng.unpin_prefix("sys") == 2
    assert _state(engines["port"]._scheduler.pager) == \
        _state(engines["jax"]._scheduler.pager)
    assert engines["port"]._scheduler.pager.pages_in_use == 0
