"""Speculative decoding through the port's engine: greedy streams equal
the port's own `generate()` (linear n-gram across ``spec_k``, token trees
across fanouts, draft-model self-drafting, forced rejection with
rollbacks across a page boundary, EOS mid-acceptance, int8 tree ≡ plain
chunked int8, prefix sharing, mid-stream preemption, the disagg pair's
speculating decode side), seeded sampled verify is reproducible with its
greedy rows exact, and `warmup` / `stats()` report the verify widths and
the adaptive state.

JAX serving streams are no oracle here (five of the seven red JAX tests
are the reference's own speculation tests), so the port is held against
itself, as the reference's speculation tests hold the reference; the
integers are held against the reference in `test_torch_spec.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import qwen25_05b
from repro_torch.models.model import Model
from repro_torch.serving.disagg import DisaggController
from repro_torch.serving.engine import GenerationEngine, SamplerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model_params():
    cfg = qwen25_05b.smoke_config()
    m = Model(cfg)
    return cfg, m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _engine(m, params, **kw):
    kw.setdefault("max_seq", 64)
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", 8)
    return GenerationEngine(m, params, **kw)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _mixed_prompts(cfg):
    """Two repetitive prompts (prompt lookup fires) and two random ones
    (it mostly falls back to plain decode)."""
    rng = np.random.default_rng(2)
    pats = [rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32)
            for _ in range(2)]
    return [np.tile(p, 5) for p in pats] + _prompts(cfg, (9, 13), seed=3)


def _refs(eng, prompts, max_new):
    return [eng.generate({"tokens": p[None]}, max_new)[0] for p in prompts]


def _pager_invariants(pager):
    free = set(pager.free_pages)
    assert len(free) == len(pager.free_pages)
    for pg in range(1, pager.cfg.num_pages):
        assert (pager.page_ref[pg] == 0) == (pg in free), pg
    pager.verify_invariants()


def _serve(eng, prompts, max_new, **kw):
    rids = [eng.submit(p, max_new, **kw) for p in prompts]
    out = eng.drain()
    assert eng._scheduler.pager.pages_in_use == 0
    _pager_invariants(eng._scheduler.pager)
    return [out[r] for r in rids]


def _oracle_drafter(oracle, cfg, wrong):
    """A draft_fn proposing the true greedy continuation, with the tokens
    ``wrong(i)`` says shifted off it."""
    def draft(reqs):
        out = {}
        for slot, rid, ctx, _q, k in reqs:
            ref, plen = oracle[rid]
            done = len(ctx) - plen
            out[slot] = [int(t) if not wrong(i) else
                         (int(t) + 1) % cfg.vocab_size
                         for i, t in enumerate(ref[done:done + k])]
        return out
    return draft


@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_ngram_identity_across_k(model_params, k):
    cfg, m, params = model_params
    prompts = _mixed_prompts(cfg)
    eng = _engine(m, params, spec_decode="ngram", spec_k=k)
    got = _serve(eng, prompts, 10)
    for g, ref in zip(got, _refs(eng, prompts, 10)):
        np.testing.assert_array_equal(g, ref)
    st = eng.stats()
    assert st.draft_tokens > 0 and 0 <= st.accepted_tokens <= st.draft_tokens
    assert st.spec_k_now == k and st.spec_fanout_now == 1


@pytest.mark.parametrize("fanout", [1, 2, 3])
def test_greedy_ngram_tree_identity_across_fanout(model_params, fanout):
    cfg, m, params = model_params
    prompts = _mixed_prompts(cfg)
    eng = _engine(m, params, spec_decode="ngram", spec_k=4, spec_tree=True,
                  spec_tree_fanout=fanout, spec_adaptive=True)
    got = _serve(eng, prompts, 10)
    for g, ref in zip(got, _refs(eng, prompts, 10)):
        np.testing.assert_array_equal(g, ref)
    assert eng.stats().draft_tokens > 0


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_draft_model_self_draft_full_acceptance(model_params, tree):
    """Draft model = the target: its greedy chain is the target's argmax
    chain, so the chain is always accepted (a tree's alternates are
    rejected and rolled back) and streams equal sequential decode."""
    cfg, m, params = model_params
    prompts = _prompts(cfg, (5, 12, 9), seed=9)
    eng = _engine(m, params, spec_decode="draft_model", spec_k=4,
                  spec_tree=tree, draft_model=m, draft_params=params)
    got = _serve(eng, prompts, 12)
    for g, ref in zip(got, _refs(eng, prompts, 12)):
        np.testing.assert_array_equal(g, ref)
    st = eng.stats()
    if tree:
        assert st.accepted_tokens > 0 and st.rollbacks > 0
    else:
        assert st.accepted_tokens == st.draft_tokens > 0
    assert st.spec_tokens_per_row > 3.0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_tree_alternate_accepted_moves_kv(model_params, kv_quant):
    """A tree draft_fn whose chain starts wrong and whose last node, a
    depth-1 alternate, is the target's token: every verify accepts the
    alternate, so `_tree_compact` moves its KV from slot q + n to
    q + 1 (the losing chain is truncated) — and the stream still equals
    sequential decode, which reads that KV on the next step."""
    cfg, m, params = model_params
    prompts = _prompts(cfg, (6, 11, 9), seed=4)
    oracle = {}

    def draft(reqs):
        out = {}
        for slot, rid, ctx, _q, k, _f in reqs:
            ref, plen = oracle[rid]
            good = int(ref[len(ctx) - plen])
            nodes = [((good + 1) % cfg.vocab_size, -1)]
            nodes += [((good + 2 + i) % cfg.vocab_size, i)
                      for i in range(k - 2)]
            out[slot] = nodes + [(good, -1)] if k > 1 else nodes
        return out

    eng = _engine(m, params, kv_quant=kv_quant, spec_decode="draft_model",
                  spec_k=4, spec_tree=True, draft_fn=draft)
    refs = _refs(eng, prompts, 10)
    rids = [eng.submit(p, 10) for p in prompts]
    for rid, p, ref in zip(rids, prompts, refs):
        oracle[rid] = (ref, len(p))
    out = eng.drain()
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)
    st = eng.scheduler_stats
    assert eng.tree_moves == st.accepted_tokens > 0
    assert st.rollbacks == st.spec_rows
    _pager_invariants(eng._scheduler.pager)


@pytest.mark.parametrize("page_size", [8, 4])
def test_forced_rejection_identity_and_rollback(model_params, page_size):
    """A drafter that always proposes wrong tokens: every verify run
    rolls back (across page boundaries at pages of 4, which returns
    pages to the pool) and streams still equal sequential greedy."""
    cfg, m, params = model_params
    prompts = _prompts(cfg, (6, 11), seed=5)
    oracle = {}
    eng = _engine(m, params, page_size=page_size, spec_decode="draft_model",
                  spec_k=6, draft_fn=_oracle_drafter(oracle, cfg,
                                                     lambda i: True))
    refs = _refs(eng, prompts, 10)
    rids = [eng.submit(p, 10) for p in prompts]
    for rid, p, ref in zip(rids, prompts, refs):
        oracle[rid] = (ref, len(p))
    out = eng.drain()
    st = eng.scheduler_stats
    assert st.accepted_tokens == 0 and st.rollbacks == st.spec_rows > 0
    if page_size == 4:
        assert st.rollback_pages > 0
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)
    _pager_invariants(eng._scheduler.pager)
    assert eng._scheduler.pager.pages_in_use == 0


def test_randomized_accept_reject_and_adaptive_k(model_params):
    """A random mix of right and wrong drafts with adaptive ``spec_k``:
    pager bookkeeping holds after every step, ``spec_k_now`` moves within
    the bucket family, and streams stay identical."""
    cfg, m, params = model_params
    prompts = _prompts(cfg, (5, 8, 11, 7, 13, 4), seed=7)
    rng = np.random.default_rng(8)
    oracle = {}
    eng = _engine(m, params, spec_decode="draft_model", spec_k=4,
                  spec_adaptive=True, page_size=4,
                  draft_fn=_oracle_drafter(oracle, cfg,
                                           lambda i: rng.random() > 0.6))
    refs = _refs(eng, prompts, 9)
    rids = [eng.submit(p, 9) for p in prompts]
    for rid, p, ref in zip(rids, prompts, refs):
        oracle[rid] = (ref, len(p))
    out, ks = {}, set()
    while not eng.idle:
        eng.step()
        _pager_invariants(eng._scheduler.pager)
        ks.add(eng.stats().spec_k_now)
        out.update(eng.collect())
    st = eng.scheduler_stats
    assert 0 < st.accepted_tokens < st.draft_tokens and st.rollbacks > 0
    assert ks <= {1, 2, 4} and len(ks) > 1
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)


def test_eos_mid_acceptance_stops_stream(model_params):
    cfg, m, params = model_params
    prompt = _prompts(cfg, (7,), seed=12)[0]
    eng = _engine(m, params, spec_decode="draft_model", spec_k=4,
                  draft_model=m, draft_params=params)
    ref = _refs(eng, [prompt], 8)[0]
    eos = int(ref[3])
    stream = _serve(eng, [prompt], 8, eos_id=eos)[0]
    cut = list(ref).index(eos) + 1
    np.testing.assert_array_equal(stream, ref[:cut])
    assert eng.scheduler_stats.accepted_tokens > 0


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_int8_spec_matches_plain_chunked_int8(model_params, tree):
    """Over int8 pools verify rows write KV through the chunk step's
    quantize-on-write codec and compaction moves raw codes and scale
    strips, so greedy spec streams equal the plain engine's int8 streams
    (and a second run reproduces them)."""
    cfg, m, params = model_params
    prompts = _mixed_prompts(cfg)[:2] + _prompts(cfg, (5, 12), seed=5)

    def serve(**kw):
        return [s.tolist() for s in _serve(
            _engine(m, params, kv_quant="int8", **kw), prompts, 10)]

    plain = serve()
    spec = serve(spec_decode="ngram", spec_k=4, spec_tree=tree)
    assert spec == plain
    assert serve(spec_decode="ngram", spec_k=4, spec_tree=tree) == spec


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_spec_with_prefix_sharing(model_params, tree):
    """Aliased prompt pages are skipped, never rolled back, and streams
    equal the unshared spec engine's."""
    cfg, m, params = model_params
    rng = np.random.default_rng(10)
    prefix = np.tile(rng.integers(0, cfg.vocab_size, 4).astype(np.int32), 4)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, t).astype(np.int32)]) for t in (4, 7, 3)]

    def serve(prefix_id):
        eng = _engine(m, params, spec_decode="ngram", spec_k=4,
                      spec_tree=tree)
        got = _serve(eng, prompts, 8, prefix_id=prefix_id)
        return [g.tolist() for g in got], eng.scheduler_stats

    shared, st_s = serve("sys")
    unshared, st_u = serve(None)
    assert shared == unshared
    assert st_s.prefix_shared_pages > 0
    assert st_s.prefill_tokens_skipped > st_u.prefill_tokens_skipped == 0
    assert st_s.draft_tokens > 0


def test_tree_spec_over_a_pinned_prefix(model_params):
    """A pinned prefix stays resident across bursts of tree-speculating
    requests: the second burst aliases its pages, rollbacks never touch
    them (`truncate` refuses shared pages), and streams equal
    sequential decode."""
    cfg, m, params = model_params
    rng = np.random.default_rng(13)
    prefix = np.tile(rng.integers(0, cfg.vocab_size, 4).astype(np.int32), 4)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, t).astype(np.int32)]) for t in (5, 3)]
    eng = _engine(m, params, spec_decode="ngram", spec_k=4, spec_tree=True,
                  kv_quant="int8")
    refs = _refs(eng, prompts, 8)
    rid = eng.submit(prompts[0], 8, prefix_id="sys")
    assert eng.pin_prefix("sys") == 0            # nothing indexed yet
    first = eng.drain()[rid]
    pinned = eng._scheduler.pager.stats().pages_pinned
    assert pinned == 2                           # sticky pin, 2 pages of 8
    rids = [eng.submit(p, 8, prefix_id="sys") for p in prompts]
    out = eng.drain()
    assert eng._scheduler.pager.pages_in_use == pinned
    np.testing.assert_array_equal(first, refs[0])
    for r, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[r], ref)
    st = eng.stats()
    assert st.prefix_shared_pages >= 4 and st.draft_tokens > 0
    assert eng.unpin_prefix("sys") == pinned
    assert eng._scheduler.pager.pages_in_use == 0


def test_tree_mid_stream_preemption_identity(model_params):
    """Preempting a slot between tree-verify steps spills its pages and
    restores them later — the streams still equal sequential decode."""
    cfg, m, params = model_params
    prompts = [np.tile(p[:3], 4)[:len(p)]
               for p in _prompts(cfg, (7, 6), seed=6)]
    eng = _engine(m, params, num_slots=2, preemption=True,
                  spec_decode="ngram", spec_k=4, spec_tree=True,
                  kv_quant="int8")
    refs = _refs(eng, prompts, 10)
    rids = [eng.submit(p, 10) for p in prompts]
    eng.step()
    eng.step()
    assert eng.preempt(rids[0])
    out = eng.drain()
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)
    st = eng.stats()
    assert st.preemptions >= 1 and st.restores == st.preemptions
    assert st.draft_tokens > 0 and st.pager.pages_used == 0


def test_disagg_decode_side_speculates(model_params):
    """A `DisaggController` with ``spec_decode="ngram"`` over int8 pools:
    the prefill side strips the speculation knobs, the decode side
    speculates, and the streams equal the unified spec engine's."""
    cfg, m, params = model_params
    prompts = _mixed_prompts(cfg)
    kw = dict(max_seq=64, num_slots=4, page_size=8, kv_quant="int8",
              spec_decode="ngram", spec_k=4)
    unified = _serve(GenerationEngine(m, params, **kw), prompts, 10)
    ctrl = DisaggController(m, params, handoff_min_tokens=12, **kw)
    rids = [ctrl.submit(p, 10) for p in prompts]
    out = ctrl.drain()
    for rid, ref in zip(rids, unified):
        np.testing.assert_array_equal(out[rid], ref)
    assert ctrl.stats().handoffs > 0
    assert ctrl.prefill.engine.spec_decode is None
    assert ctrl.decode.engine.stats().draft_tokens > 0


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_sampled_verify_deterministic_and_greedy_rows_exact(model_params,
                                                            tree):
    """Sampled rows ride the verify step (greedy rows through a one-hot
    target in the tree walk): a seeded engine reproduces every stream,
    and the greedy row equals sequential greedy decode."""
    cfg, m, params = model_params
    prompts = _prompts(cfg, (6, 9, 7), seed=11)
    greedy_prompt = np.tile(prompts[0][:3], 4)

    def serve():
        eng = _engine(m, params, spec_decode="ngram", spec_k=3,
                      spec_tree=tree, seed=5)
        r_g = eng.submit(greedy_prompt, 10)
        r_h = eng.submit(prompts[1], 10,
                         sampler=SamplerConfig(temperature=1.5, top_k=8))
        r_w = eng.submit(prompts[2], 10,
                         sampler=SamplerConfig(temperature=0.7))
        out = eng.drain()
        assert eng._scheduler.pager.pages_in_use == 0
        return [out[r].tolist() for r in (r_g, r_h, r_w)], eng

    a, eng = serve()
    b, _ = serve()
    assert a == b
    assert a[0] == _refs(eng, [greedy_prompt], 10)[0].tolist()
    assert [len(s) for s in a] == [10, 10, 10]
    assert eng.stats().draft_tokens > 0


def test_warmup_runs_the_verify_widths(model_params):
    """`warmup` runs every width of `width_family(chunk, spec_k)` and,
    from width 2 up, the verify (and tree verify) step too; it counts
    nothing in `stats()`."""
    cfg, m, params = model_params
    for kw, per_width in ((dict(), 1), (dict(spec_decode="ngram"), 2),
                          (dict(spec_decode="ngram", spec_tree=True), 3)):
        eng = _engine(m, params, spec_k=4, prefill_chunk=8, **kw)
        n = eng.warmup()
        widths = eng._scheduler.width_buckets
        assert widths == ([1, 2, 4, 8] if not kw else [1, 2, 3, 4, 5, 8])
        assert n == 1 + per_width * (len(widths) - 1)
        st = eng.stats()
        assert st.dispatches == 0 and st.draft_tokens == 0
        assert st.spec_fanout_now == (2 if kw.get("spec_tree") else 1)


def test_fresh_engine_stats_report_the_starting_spec_state(model_params):
    """A fresh engine reports the draft length and fanout serving will
    start with, before allocating anything."""
    cfg, m, params = model_params
    eng = _engine(m, params, spec_decode="ngram", spec_k=3, spec_tree=True,
                  spec_tree_fanout=5)
    st = eng.stats()
    assert eng._scheduler is None
    assert (st.spec_k_now, st.spec_fanout_now) == (3, 2)
    eng.submit(np.arange(4, dtype=np.int32), 2)
    assert (eng.stats().spec_k_now, eng.stats().spec_fanout_now) == (3, 2)
    eng.drain()
