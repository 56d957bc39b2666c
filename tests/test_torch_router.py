"""The port's fleet `Router`, ported from `tests/test_router.py`.

The single-device tests of the reference (the tensor-parallel two-replica
case needs a mesh, which the port does not have yet): deterministic
scoring, the affinity / load / SLO trade-offs, session stickiness across
drain and re-join, the one-replica-fleet ≡ bare-engine identity,
zero-loss `drain_replica`, and the in-place `SchedulerStats.zero()`.
Placement scores are held exactly against the JAX package's `Router`
scoring the very same replicas (its scoring reads only
`prefix_reuse_pages`, `stats()` and `num_active`, which the port's
engine exposes).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import router as jrouter
from repro_torch.configs import qwen25_05b
from repro_torch.core.pipeline import quantize_params
from repro_torch.models.model import Model
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import SchedulerStats


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


KW = dict(max_seq=96, num_slots=4, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def mp():
    cfg = qwen25_05b.smoke_config()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    return m, quantize_params(p)[0], cfg


def _prompts(cfg, n, prefix_len=32, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (prefix_len,)).astype(np.int32)
    return prefix, [np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)])
        for _ in range(n)]


def _assert_scores_match_jax(router, tokens, **kw):
    """The JAX package's Router, over the same replicas, with the same
    knobs and the same placement ledger, scores every replica alike."""
    jr = jrouter.Router(router.replicas,
                        affinity_threshold=router.affinity_threshold)
    jr._rid_map = dict(router._rid_map)
    jr._draining = set(router._draining)
    scores = router.placement_scores(tokens, **kw)
    assert scores == jr.placement_scores(tokens, **kw)
    return scores


# ---------------------------------------------------------------- placement

def test_placement_scores_deterministic(mp):
    m, params, cfg = mp
    router = Router([GenerationEngine(m, params, **KW) for _ in range(2)])
    _, prompts = _prompts(cfg, 1)
    s1 = _assert_scores_match_jax(router, prompts[0], prefix_id="sys")
    assert s1 == router.placement_scores(prompts[0], prefix_id="sys")
    assert router.place(prompts[0], prefix_id="sys") \
        == router.place(prompts[0], prefix_id="sys") == 0


def test_affinity_beats_load_only_above_threshold(mp):
    m, params, cfg = mp
    warm = GenerationEngine(m, params, **KW)
    cold = GenerationEngine(m, params, **KW)
    prefix, prompts = _prompts(cfg, 3)
    warm.pin_prefix("sys")
    warm.submit(prompts[0], 2, prefix_id="sys")
    warm.drain()
    pages = warm.prefix_reuse_pages(prompts[1], "sys")
    assert pages == len(prefix) // KW["page_size"]      # 4 full pages
    warm.submit(prompts[1], 16, prefix_id="sys")        # load, not stepped
    warm.submit(prompts[2], 16, prefix_id="sys")

    low = Router([warm, cold], affinity_threshold=pages)
    _assert_scores_match_jax(low, prompts[1], prefix_id="sys")
    assert low.place(prompts[1], prefix_id="sys") == 0
    high = Router([warm, cold], affinity_threshold=pages + 1)
    _assert_scores_match_jax(high, prompts[1], prefix_id="sys")
    assert high.place(prompts[1], prefix_id="sys") == 1
    warm.drain()


def test_interactive_avoids_batch_heavy_replica(mp):
    m, params, cfg = mp
    warm = GenerationEngine(m, params, **KW)
    cold = GenerationEngine(m, params, **KW)
    _, prompts = _prompts(cfg, 1)
    router = Router([warm, cold])
    warm.pin_prefix("sys")
    router.submit(prompts[0], 2, prefix_id="sys")       # lands on 0 (tie)
    router.drain()
    for _ in range(6):
        router.submit(prompts[0], 16, prefix_id="sys")
    for prio in (0, 1):
        _assert_scores_match_jax(router, prompts[0], prefix_id="sys",
                                 priority=prio)
    assert router.place(prompts[0], prefix_id="sys") == 0
    assert router.place(prompts[0], prefix_id="sys", priority=1) == 1
    router.drain()


# ------------------------------------------------- identity + drain / join

def test_one_replica_fleet_matches_bare_engine(mp):
    m, params, cfg = mp
    _, prompts = _prompts(cfg, 4)
    eng = GenerationEngine(m, params, **KW)
    refs = [eng.submit(p, 8, prefix_id="sys") for p in prompts]
    rout = eng.drain()
    want = [list(rout[r]) for r in refs]

    fleet = Router([GenerationEngine(m, params, **KW)])
    rids = [fleet.submit(p, 8, prefix_id="sys") for p in prompts]
    out = fleet.drain()
    assert [list(out[r]) for r in rids] == want


def test_drain_under_load_loses_nothing(mp):
    m, params, cfg = mp
    _, prompts = _prompts(cfg, 6)
    eng = GenerationEngine(m, params, **KW)
    refs = [eng.submit(p, 8, prefix_id="sys") for p in prompts]
    rout = eng.drain()
    want = [list(rout[r]) for r in refs]

    fleet = Router([GenerationEngine(m, params, **KW) for _ in range(2)])
    rids = [fleet.submit(p, 8, prefix_id="sys") for p in prompts * 2]
    for _ in range(2):
        fleet.step()
    _assert_scores_match_jax(fleet, prompts[0], prefix_id="sys")
    fleet.drain_replica(0)
    assert fleet.replicas[0].idle
    assert fleet.placement_scores(prompts[0])[0] == float("-inf")
    out = fleet.drain()
    assert sorted(out) == sorted(rids)          # exactly once, no extras
    assert [list(out[r]) for r in rids] == want + want
    assert fleet.router_stats.drains == 1
    assert fleet.router_stats.reroutes >= 1


def test_session_stickiness_survives_drain_and_rejoin(mp):
    m, params, cfg = mp
    _, prompts = _prompts(cfg, 1)
    fleet = Router([GenerationEngine(m, params, **KW) for _ in range(2)])
    p = prompts[0]
    fleet.submit(p, 4, prefix_id="sys", session_id="alice")
    fleet.drain()
    home = fleet._sessions["alice"]
    i_home = next(i for i, r in enumerate(fleet.replicas) if r is home)
    assert fleet.place(p, session_id="alice") == i_home

    fleet.drain_replica(i_home)
    i_new = fleet.place(p, session_id="alice")
    assert i_new != i_home
    fleet.submit(p, 4, prefix_id="sys", session_id="alice")
    fleet.drain()
    assert fleet._sessions["alice"] is fleet.replicas[i_new]
    assert fleet.router_stats.session_hits == 0

    fleet.add_replica(fleet.replicas[i_home])   # re-join, pages warm
    assert fleet.place(p, session_id="alice") == i_new
    fleet.submit(p, 2, prefix_id="sys", session_id="alice")
    assert fleet.router_stats.session_hits == 1
    fleet.drain()


def test_add_remove_replica_guards(mp):
    m, params, cfg = mp
    _, prompts = _prompts(cfg, 1)
    fleet = Router([GenerationEngine(m, params, **KW) for _ in range(2)])
    rid = fleet.submit(prompts[0], 4)           # tie-break: replica 0
    with pytest.raises(RuntimeError, match="not idle"):
        fleet.remove_replica(0)
    while not fleet.idle:                       # finish, but don't collect
        fleet.step()
    fleet.drain_replica(0)
    dropped = fleet.remove_replica(0)
    assert fleet.num_replicas == 1
    with pytest.raises(RuntimeError, match="last replica"):
        fleet.remove_replica(0)
    assert rid in fleet.collect()
    assert fleet.add_replica(dropped, warmup=True) == 1
    assert fleet.num_replicas == 2


# ----------------------------------------------------------- stats reset

def test_reset_stats_zeroes_in_place(mp):
    m, params, cfg = mp
    _, prompts = _prompts(cfg, 2)
    eng = GenerationEngine(m, params, **KW)
    assert eng.warmup() == len(eng._scheduler.width_buckets)
    assert eng.stats().dispatches == 0          # warmup counts nothing
    for p in prompts:
        eng.submit(p, 4, prefix_id="sys")
    eng.drain()
    live = eng._scheduler.stats
    assert live.decode_steps > 0 and live.prefill_tokens_skipped > 0
    eng.reset_stats()
    assert eng._scheduler.stats is live
    assert live.decode_steps == 0 and live.admitted == 0
    assert live.prefill_tokens_skipped == 0
    eng.submit(prompts[0], 2, prefix_id="sys")
    eng.drain()
    assert live.decode_steps > 0


def test_stats_zero_spares_no_default_fields():
    @dataclasses.dataclass
    class BoundStats(SchedulerStats):
        owner: object = dataclasses.field(kw_only=True)   # no default

    s = BoundStats(owner="engine-7")
    s.admitted, s.decode_steps, s.prefill_tokens_skipped = 3, 11, 5
    s.zero()
    assert (s.admitted, s.decode_steps, s.prefill_tokens_skipped) == (0, 0, 0)
    assert s.owner == "engine-7"
    with pytest.raises(TypeError):
        type(s)()
