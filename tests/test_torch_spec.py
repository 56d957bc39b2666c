"""Speculative decoding in the port, held against the JAX package.

  * drafters — `ngram_propose`, `ngram_propose_tree`, `spec_k_buckets`
    and `width_family(chunk, spec_k)` equal the reference's on seeded
    contexts;
  * scheduler — the port's `Scheduler` and the reference's side by side
    over a deterministic token chain (the next token is a pure function
    of the previous token and its logical position) with a seeded fake
    drafter, linear and tree-shaped: after every step the events, every
    `run_batch` call's integers (tokens, positions, ``n_draft``, the
    tree's ``rpos`` / ``amask`` / ``parents``), every integer counter,
    the pager state, the slots and the adaptive ``spec_k_cur`` /
    ``fanout_cur`` must be equal, and every stream must equal the
    chain's sequential one;
  * device-side acceptance — `_tree_walk_greedy` on the same inputs,
    `_tree_compact` on the same int8 and bf16 pools (bit-equal), and one
    greedy verify step (linear and tree) on bridged params and pools:
    logits within f32 tolerance, ``fix`` / ``n_acc`` / ``path`` and the
    pools after compaction equal.

The port's engine streams are held against its own `generate()` in
`test_torch_tree_spec.py` (five of the seven red JAX tests are the
reference's speculation tests, so JAX streams are no oracle here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen25_05b as jcfgs
from repro.models import build_model as jbuild
from repro.serving import GenerationEngine as JEngine
from repro.serving import engine as jeng_mod
from repro.serving import kv_pager as jkv
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.models.model import Model
from repro_torch.serving import engine as teng_mod
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
# Drafters and bucket families (pure numpy: exact equality)
# ---------------------------------------------------------------------------

def _contexts(seed: int) -> list[np.ndarray]:
    """Random, periodic and periodic-with-noise contexts, short and past
    the 512-token window."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, v, n).astype(np.int32)
           for v, n in ((4, 9), (6, 40), (50, 30), (3, 700))]
    for period, n in ((3, 17), (5, 64), (24, 600)):
        motif = rng.integers(0, 100, period).astype(np.int32)
        ctx = np.resize(motif, n)
        out.append(ctx)
        noisy = ctx.copy()
        noisy[rng.integers(0, n, max(1, n // 8))] = 7
        out.append(noisy)
    out += [np.array([7], np.int32), np.array([7, 7], np.int32)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_propose_equals_reference(seed):
    for ctx in _contexts(seed):
        for k in (1, 2, 4, 7):
            for max_n in (1, 3, 5):
                assert tsched.ngram_propose(ctx, k, max_n) == \
                    jsched.ngram_propose(ctx, k, max_n), (len(ctx), k, max_n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_propose_tree_equals_reference(seed):
    for ctx in _contexts(seed):
        for budget in (1, 2, 4, 6):
            for fanout in (1, 2, 3):
                for max_n in (1, 3):
                    got = tsched.ngram_propose_tree(ctx, budget, fanout,
                                                    max_n)
                    assert got == jsched.ngram_propose_tree(
                        ctx, budget, fanout, max_n), (len(ctx), budget,
                                                      fanout, max_n)
                    assert all(p < i for i, (_, p) in enumerate(got))


def test_spec_k_buckets_and_width_family_equal_reference():
    for k in range(1, 18):
        assert tsched.spec_k_buckets(k) == jsched.spec_k_buckets(k)
    for chunk in (1, 2, 3, 4, 7, 8, 16, 33, 64):
        for k in (0, 1, 2, 3, 4, 6, 8, 15):
            assert tsched.width_family(chunk, k) == \
                jsched.width_family(chunk, k), (chunk, k)


# ---------------------------------------------------------------------------
# Scheduler beside the reference's over a deterministic token chain
# ---------------------------------------------------------------------------

def _chain(tok: int, pos: int) -> int:
    return (tok * 7 + pos) % 1000 + 1


def _ref_stream(prompt: np.ndarray, max_new: int) -> list[int]:
    out, last, q = [], int(prompt[-1]), len(prompt) - 1
    for _ in range(max_new):
        last = _chain(last, q)
        out.append(last)
        q += 1
    return out


class _ChainExec:
    """`run_batch` over the chain model with the draft/verify contract:
    the target token after the input at (token, logical position) is
    `_chain`; linear rows accept their leading matching drafts, tree rows
    walk the first matching child at each node. Records every call."""

    def __init__(self):
        self.calls = []

    def run_batch(self, tokens, pos, row_slots, sample_idx, temps, topks,
                  n_draft=None, tree=None):
        self.calls.append(dict(
            tokens=tokens.tolist(), pos=pos.tolist(),
            row_slots=row_slots.tolist(), sample_idx=sample_idx.tolist(),
            n_draft=None if n_draft is None else n_draft.tolist(),
            tree=None if tree is None else {k: v.tolist()
                                             for k, v in tree.items()}))
        b, c = tokens.shape
        rpos = pos if tree is None else tree["rpos"]
        fix = np.zeros(b, np.int32)
        acc = np.zeros(b, np.int32)
        path = np.zeros((b, c), np.int32)
        for r in range(b):
            cur = int(sample_idx[r])
            nd = 0 if n_draft is None else int(n_draft[r])
            depth = 0
            while True:
                want = _chain(int(tokens[r, cur]), int(rpos[r, cur]))
                if tree is None:
                    kids = [cur + 1] if (depth < nd and int(
                        tokens[r, cur + 1]) == want) else []
                else:
                    kids = [j for j in range(1, nd + 1)
                            if tree["parents"][r, j] == cur
                            and int(tokens[r, j]) == want]
                if not kids:
                    break
                cur = kids[0]
                path[r, depth] = cur
                depth += 1
            acc[r] = depth
            fix[r] = want
        if tree is not None:
            return fix, acc, path
        return fix if n_draft is None else (fix, acc)


def _hit(rid: int, q: int, i: int) -> bool:
    """A deterministic coin: does this draft token follow the chain?"""
    return (rid * 7 + q * 5 + i * 3) % 11 > 3


def _linear_drafter(reqs):
    out = {}
    for slot, rid, ctx, q, k in reqs:
        toks, last = [], int(ctx[-1])
        for i in range(1 + (rid + q) % k):        # 1 … k drafts
            nxt = _chain(last, q + i)
            if not _hit(rid, q, i):
                nxt = nxt % 997 + 2                # off the chain
            toks.append(nxt)
            last = nxt
        out[slot] = toks
    return out


def _tree_drafter(reqs):
    """A chain whose first token is sometimes wrong, plus up to
    ``fanout - 1`` depth-1 alternates, one of which may be right."""
    out = {}
    for slot, rid, ctx, q, k, fanout in reqs:
        good = _chain(int(ctx[-1]), q)
        n_alt = min(fanout - 1, k - 1)
        chain_ok = _hit(rid, q, -1)
        nodes, last = [], good if chain_ok else good % 991 + 3
        nodes.append((last, -1))
        for i in range(1, k - n_alt):
            nxt = _chain(last, q + i)
            if not _hit(rid, q, i):
                nxt = nxt % 997 + 2
            nodes.append((nxt, i - 1))
            last = nxt
        for a in range(n_alt):
            right = not chain_ok and a == (rid + q) % n_alt
            nodes.append((good if right else good % 983 + 5 + a, -1))
        out[slot] = nodes
    return out


def _prompt(rid: int, n: int) -> np.ndarray:
    return ((np.arange(n) * 13 + rid * 101) % 900 + 1).astype(np.int32)


def _pager_state(p):
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free_pages=list(p.free_pages), free_slots=list(p.free_slots),
                slot_pages={k: list(v) for k, v in p.slot_pages.items()},
                slot_len=p.slot_len.tolist(), reserved=dict(p.slot_reserved),
                committed=dict(p.slot_committed), version=p.version,
                stats=dataclasses.asdict(p.stats()))


def _int_stats(st) -> dict:
    d = dataclasses.asdict(st)
    d.pop("restore_time_s")
    return d


class _Twin:
    """The port's scheduler and the reference's over the same pager
    shape, chain executors and drafter; every step must agree."""

    def __init__(self, num_slots=3, pages_per_slot=8, page_size=4,
                 num_pages=None, optimistic=False, chunk=4, **kw):
        self.execs = [_ChainExec(), _ChainExec()]
        self.pair = []
        for (kv, sc), ex in zip(((tkv, tsched), (jkv, jsched)), self.execs):
            pager = kv.KVPager(kv.PagerConfig(
                num_pages=num_pages or num_slots * pages_per_slot + 1,
                page_size=page_size, num_slots=num_slots,
                pages_per_slot=pages_per_slot, optimistic=optimistic))
            self.pair.append(sc.Scheduler(pager, run_batch=ex.run_batch,
                                          chunk_size=chunk, **kw))
        self.port, self.ref = self.pair
        self.prompts = {}

    def submit(self, rid, n, max_new, **kw):
        self.prompts[rid] = (_prompt(rid, n), max_new)
        for sc, s in zip((tsched, jsched), self.pair):
            s.submit(sc.Request(rid=rid, tokens=_prompt(rid, n),
                                max_new_tokens=max_new, **kw))
        self.check()

    def step(self):
        ev = [s.step() for s in self.pair]
        assert ev[0] == ev[1]
        self.check()
        return ev[0]

    def check(self):
        p, r = self.pair
        assert self.execs[0].calls == self.execs[1].calls
        assert _int_stats(p.stats) == _int_stats(r.stats)
        assert _pager_state(p.pager) == _pager_state(r.pager)
        assert (p.spec_k_cur, p.fanout_cur, p._accept_ema) == \
            (r.spec_k_cur, r.fanout_cur, r._accept_ema)
        view = [{s: (st.request.rid, list(st.generated), st.committed)
                 for s, st in x.slots.items()} for x in self.pair]
        assert view[0] == view[1]
        assert [q.rid for q in p.queue] == [q.rid for q in r.queue]
        p.pager.verify_invariants()

    def run(self, submit_at=None) -> dict:
        """Step to idle (submitting ``submit_at[step]`` on the way) and
        check every stream against the chain's sequential one."""
        submit_at = dict(submit_at or {})
        steps = 0
        while not self.ref.idle or submit_at:
            for args in submit_at.pop(steps, ()):
                self.submit(*args)
            self.step()
            steps += 1
            assert steps < 2000
        out = [{**dict(s.finished)} for s in self.pair]
        assert {k: v.tolist() for k, v in out[0].items()} == \
            {k: v.tolist() for k, v in out[1].items()}
        for rid, (prompt, new) in self.prompts.items():
            got = out[0][rid].tolist()
            assert got == _ref_stream(prompt, new)[:len(got)], rid
        return out[0]


def _workload(tw: _Twin, eos=None):
    for rid, (n, new) in enumerate(((5, 14), (9, 20), (3, 11))):
        tw.submit(rid, n, new)
    later = {3: [(3, 7, 9)], 6: [(4, 12, 17), (5, 2, 6)]}
    return later


_CASES = {
    "linear": dict(spec_decode="draft_fn", spec_k=4,
                   draft_fn=_linear_drafter),
    "linear_adaptive": dict(spec_decode="draft_fn", spec_k=4,
                            adaptive_spec_k=True, draft_fn=_linear_drafter),
    "tree": dict(spec_decode="draft_fn", spec_k=4, spec_tree=True,
                 spec_tree_fanout=3, draft_fn=_tree_drafter),
    "tree_adaptive": dict(spec_decode="draft_fn", spec_k=6, spec_tree=True,
                          spec_tree_fanout=3, adaptive_spec_k=True,
                          draft_fn=_tree_drafter),
    "ngram_adaptive": dict(spec_decode="ngram", spec_k=4,
                           adaptive_spec_k=True, ngram_max=2),
    "ngram_tree": dict(spec_decode="ngram", spec_k=4, spec_tree=True,
                       adaptive_spec_k=True, ngram_max=2),
    "optimistic": dict(spec_decode="draft_fn", spec_k=4, spec_tree=True,
                       draft_fn=_tree_drafter, preemption=True,
                       optimistic=True, num_pages=13),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_scheduler_spec_lockstep_with_reference(case):
    kw = dict(_CASES[case])
    tw = _Twin(**kw)
    tw.run(_workload(tw))
    st = tw.port.stats
    if case.startswith(("linear", "tree", "optimistic")):
        assert st.draft_tokens > st.accepted_tokens > 0
        assert st.rollbacks > 0 and st.rollback_pages > 0
    assert st.finished == 6
    if kw.get("spec_tree"):
        assert any(c["tree"] for c in tw.execs[0].calls)
    if case == "optimistic":
        assert st.pressure_spills > 0
    assert tw.port.pager.pages_in_use == 0


def test_scheduler_adaptive_trajectories_equal_reference():
    """Forced full rejection then full acceptance: ``spec_k_cur`` walks
    4 → 2 → 1 → … → 4 and the fanout widens then narrows, step for step
    the reference's trajectory."""
    mode = {"right": False}

    def drafter(reqs):
        out = {}
        for slot, _rid, ctx, q, k, fanout in reqs:
            good = _chain(int(ctx[-1]), q)
            first = good if mode["right"] else good % 991 + 3
            nodes, last = [(first, -1)], first
            for i in range(1, k):
                last = _chain(last, q + i)
                nodes.append((last, i - 1))
            out[slot] = nodes
        return out

    tw = _Twin(num_slots=1, pages_per_slot=16, spec_decode="draft_fn",
               spec_k=4, spec_tree=True, spec_tree_fanout=4,
               adaptive_spec_k=True, draft_fn=drafter)
    tw.submit(0, 4, 50)
    traj = []
    for i in range(14):
        if i == 6:
            mode["right"] = True
        tw.step()
        traj.append((tw.port.spec_k_cur, tw.port.fanout_cur))
    assert (1, 4) in traj and traj[-1][0] == 4 and traj[-1][1] < 4
    tw.run()


def test_scheduler_draft_cap_and_non_topological_tree():
    """Drafts are capped at the remaining budget minus one; a draft_fn
    tree whose parent follows its child is refused by both."""
    seen = []

    def drafter(reqs):
        seen.extend(k for *_r, k in reqs)
        return _linear_drafter(reqs)

    tw = _Twin(spec_decode="draft_fn", spec_k=6, draft_fn=drafter)
    tw.submit(0, 4, 5)
    tw.run()
    assert seen and max(seen) <= 3

    def bad(reqs):
        return {slot: [(7, 1), (8, -1)] for slot, *_ in reqs}

    for sc in (tsched, jsched):
        kv = tkv if sc is tsched else jkv
        s = sc.Scheduler(kv.KVPager(kv.PagerConfig(9, 4, 2, 4)),
                         run_batch=_ChainExec().run_batch, chunk_size=4,
                         spec_decode="draft_fn", spec_k=4, spec_tree=True,
                         draft_fn=bad)
        s.submit(sc.Request(rid=0, tokens=_prompt(0, 4), max_new_tokens=8))
        s.step()
        with pytest.raises(ValueError, match="non-topological tree"):
            s.step()


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_preempt_mid_spec_run_rollback_then_spill(tree):
    """The reference's `test_preempt_mid_spec_run_rollback_then_spill`: a
    verify step that truncated rejected drafts, then a spill of the same
    slot right away, then restore — in lockstep with the reference, and
    the stream equals the chain's."""
    def draft(reqs):
        out = {}
        for slot, _rid, ctx, q, k, *fan in reqs:
            good = _chain(int(ctx[-1]), q)
            toks = [good] + [999] * (k - 1) if k >= 2 else [good]
            out[slot] = ([(t, i - 1) for i, t in enumerate(toks)] if fan
                         else toks)
        return out

    tw = _Twin(num_slots=1, pages_per_slot=8, page_size=4, num_pages=17,
               spec_decode="draft_fn", spec_k=3, spec_tree=tree,
               draft_fn=draft, preemption=True)
    tw.submit(0, 4, 12)
    for _ in range(3):
        tw.step()
    assert tw.port.stats.rollbacks > 0
    got = [s.preempt_request(0) for s in tw.pair]
    assert got == [True, True]
    tw.check()
    out = tw.run()
    assert list(out[0]) == _ref_stream(_prompt(0, 4), 12)
    st = tw.port.stats
    assert st.preemptions == 1 and st.restores == 1
    assert tw.port.pager.pages_in_use == 0 and not tw.port.preempted


# ---------------------------------------------------------------------------
# Device-side acceptance against the reference's functions
# ---------------------------------------------------------------------------

def _random_trees(rng, b, c, k):
    """Rows of random topological trees of 0 … k nodes (in-row indices
    1 … n), their tokens, and target argmaxes that follow some branch."""
    tokens = rng.integers(0, 6, (b, c)).astype(np.int32)
    parents = np.full((b, c), -1, np.int32)
    n_draft = rng.integers(0, k + 1, b).astype(np.int32)
    for r in range(b):
        for j in range(1, n_draft[r] + 1):
            parents[r, j] = rng.integers(0, j)
    g = rng.integers(0, 6, (b, k + 1)).astype(np.int32)
    for r in range(0, b, 2):                # even rows: g follows a branch
        node = int(rng.integers(0, n_draft[r] + 1))
        while node > 0:
            g[r, parents[r, node]] = tokens[r, node]
            node = parents[r, node]
    return g, tokens, parents, n_draft


@pytest.mark.parametrize("seed", range(4))
def test_tree_walk_greedy_equals_reference(seed):
    rng = np.random.default_rng(seed)
    g, tokens, parents, n_draft = _random_trees(rng, 16, 7, 5)
    want = jeng_mod._tree_walk_greedy(jnp.asarray(g), jnp.asarray(tokens),
                                      jnp.asarray(parents),
                                      jnp.asarray(n_draft), 5)
    got = teng_mod._tree_walk_greedy(*(torch.from_numpy(a) for a in (
        g, tokens, parents, n_draft)), 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(want[1]).max() >= 2          # some walk went deep


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params): the smoke config
    with Qwen2.5's grouping and f32 activations."""
    kw = dict(num_heads=14, num_kv_heads=2, activation_dtype="float32")
    jm = jbuild(dataclasses.replace(jcfgs.smoke_config(), **kw))
    tm = Model(dataclasses.replace(tcfgs.smoke_config(), **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return jm, jp, tm, tp


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _random_pools(jm, kv_quant, rng, num_pages=12, page_size=4):
    cache = _np_tree(jm.init_paged_cache(2, num_pages, page_size, 32,
                                         kv_quant=kv_quant))
    for entry in cache.values():
        pool = entry["kv_pool"]
        for k, a in pool.items():
            if a.dtype == np.int8:
                pool[k] = rng.integers(-127, 128, a.shape).astype(np.int8)
            else:
                pool[k] = rng.standard_normal(a.shape).astype(a.dtype)
    return cache


def _assert_pools_equal(tcache, jcache, scale_rtol=0.0):
    """Every page but the scratch page 0 equal: codes and bf16 words
    exactly, f32 scale strips within ``scale_rtol`` (0: exactly)."""
    for seg, entry in jcache.items():
        for i, layer in enumerate(tcache[seg]):
            for k, leaf in layer["kv_pool"].items():
                got, ref = leaf[1:], np.asarray(entry["kv_pool"][k][i, 1:])
                if got.dtype == torch.bfloat16:
                    got, ref = got.view(torch.int16), ref.view(np.int16)
                if got.dtype == torch.float32:
                    np.testing.assert_allclose(got.numpy(), ref,
                                               rtol=scale_rtol, atol=0)
                else:
                    np.testing.assert_array_equal(got.numpy(), ref, k)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_tree_compact_equals_reference(models, kv_quant):
    """Chained, no-op, beyond-``n_acc`` and padding moves on the same
    pools: every page but the scratch page 0 bit-equal, and the moves a
    row equal to the reference's live count."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(7)
    jcache = _random_pools(jm, kv_quant, rng)
    tcache = bridge.paged_cache_to_torch(jcache, device="cpu")
    pt = np.array([[3, 5, 7, 0], [1, 2, 4, 6], [8, 9, 10, 11],
                   [0, 0, 0, 0]], np.int32)
    q = np.array([2, 5, 9, -1], np.int32)
    path = np.array([[3, 4, 0], [1, 3, 5], [2, 1, 4], [1, 2, 3]], np.int32)
    n_acc = np.array([2, 3, 1, 3], np.int32)
    jeng = JEngine(jm, jp, max_seq=32, page_size=4, num_slots=2)
    jout = jeng._tree_compact(jax.tree_util.tree_map(jnp.asarray, jcache),
                              jnp.asarray(pt), jnp.asarray(q),
                              jnp.asarray(path), jnp.asarray(n_acc))
    teng = GenerationEngine(tm, tp, max_seq=32, page_size=4, num_slots=2)
    teng._paged_cache = tcache
    moved = teng._tree_compact(*(torch.from_numpy(a) for a in (
        pt, q, path, n_acc)))
    _assert_pools_equal(tcache, _np_tree(jout))
    t = np.arange(1, 4)[None]
    live = (t <= n_acc[:, None]) & (path != t) & (q[:, None] >= 0)
    np.testing.assert_array_equal(moved.numpy(), live.sum(1))
    assert moved.sum() > 3


def _verify_inputs(jm, jp, jcache, table, r):
    """A prefill step filling rows 0 and 1's context, then a verify step:
    row 0 drafts the target's own greedy chain (every draft accepted),
    row 1 its first token then a wrong one, row 2 a completing prompt
    (no drafts), row 3 padding. Drafts come from the JAX model on a copy
    of the pools. Returns (prefill inputs, verify inputs)."""
    rng = np.random.default_rng(3)
    c = 8
    toks = rng.integers(0, 512, (4, c)).astype(np.int32)
    pos = np.full((4, c), -1, np.int32)
    pos[0], pos[1, :6] = np.arange(8), np.arange(6)
    pos[2, :3] = np.arange(3)
    pre = (toks, pos, np.array([7, 5, 2, 0], np.int32))
    _, jcache = jm.chunk_step(jp, jcache, *map(jnp.asarray, pre),
                              jnp.asarray(table))
    vt = np.zeros((4, c), np.int32)
    vp = np.full((4, c), -1, np.int32)
    vt[0, 0], vp[0, :r] = 11, np.arange(8, 8 + r)
    vt[1, 0], vp[1, :3] = 13, np.arange(6, 9)
    vt[2, :4], vp[2, :4] = rng.integers(0, 512, 4), np.arange(3, 7)
    sidx = np.array([0, 0, 3, 0], np.int32)
    n_draft = np.array([r - 1, 2, 0, 0], np.int32)
    for j in range(r - 1):                  # greedy chain, one at a time
        lg, _ = jm.chunk_step(jp, jcache, jnp.asarray(vt), jnp.asarray(vp),
                              jnp.asarray(sidx), jnp.asarray(table),
                              num_logits=r)
        g = np.asarray(jnp.argmax(lg, -1))
        vt[0, j + 1] = g[0, j]
        if j == 0:
            vt[1, 1], vt[1, 2] = g[1, 0], (g[1, 0] + 1) % 512
    return pre, (vt, vp, sidx, n_draft), jcache


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_spec_greedy_verify_equals_reference(models, kv_quant):
    """The same verify step through the reference's `_spec_greedy_fn`
    and the port's `_spec_greedy`: the ``spec_k + 1`` logits a row agree
    at f32 tolerance (the bf16-cache tolerance of `test_torch_model.py`
    over bf16 pools), ``fix`` and ``n_acc`` are equal, and so are the
    int8 codes written."""
    jm, jp, tm, tp = models
    k = 3
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [7, 8, 0, 0],
                      [0, 0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(4, 9, 4, 16, kv_quant=kv_quant)
    _, (vt, vp, sidx, nd), jcache = _verify_inputs(jm, jp, jcache, table,
                                                     k + 1)
    tcache = bridge.paged_cache_to_torch(_np_tree(jcache), device="cpu")
    tcache2 = bridge.paged_cache_to_torch(_np_tree(jcache), device="cpu")
    jlog, _ = jm.chunk_step(jp, jcache, jnp.asarray(vt), jnp.asarray(vp),
                            jnp.asarray(sidx), jnp.asarray(table),
                            num_logits=k + 1)
    tlog, _ = tm.chunk_step(tp, tcache2, *(torch.from_numpy(a) for a in (
        vt, vp, sidx)), page_table=torch.from_numpy(table),
        num_logits=k + 1)
    jeng = JEngine(jm, jp, max_seq=16, page_size=4, spec_decode="ngram",
                   spec_k=k)
    fix, n_acc, jcache = jeng._spec_greedy_fn(
        jp, jcache, jnp.asarray(table), jnp.asarray(vt), jnp.asarray(vp),
        jnp.arange(4, dtype=jnp.int32), jnp.asarray(sidx), jnp.asarray(nd))
    teng = GenerationEngine(tm, tp, max_seq=16, page_size=4,
                            spec_decode="ngram", spec_k=k)
    teng._paged_cache = tcache
    tfix, tn = teng._spec_greedy(*(torch.from_numpy(a) for a in (
        table, vt, vp, sidx, nd)))
    # logits at padding positions attend over nothing: not compared
    at = np.clip(sidx[:, None] + np.arange(k + 1), 0, vp.shape[1] - 1)
    real = np.take_along_axis(vp, at, 1) >= 0
    # f32 everywhere over int8 pools; over bf16 pools a ~1e-7 difference
    # may round one cached element to its bf16 neighbour, which
    # `test_torch_model.py` measures and bounds at 5e-3
    tol = 2e-5 if kv_quant == "int8" else 5e-3
    np.testing.assert_allclose(tlog.numpy()[real], np.asarray(jlog)[real],
                               rtol=tol, atol=tol)
    live = [0, 1, 2]
    np.testing.assert_array_equal(tn.numpy()[live], np.asarray(n_acc)[live])
    np.testing.assert_array_equal(tfix.numpy()[live], np.asarray(fix)[live])
    assert list(tn.numpy()[:3]) == [k, 1, 0]
    if kv_quant == "int8":
        _assert_pools_equal(tcache, _np_tree(jcache), scale_rtol=2e-5)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_tree_greedy_verify_equals_reference(models, kv_quant):
    """One tree verify step (a chain plus an alternate that the target
    takes, so its KV moves) through the reference's `_tree_greedy_fn`
    and the port's `_tree_greedy`: ``fix`` / ``n_acc`` / ``path`` equal,
    and the compacted int8 pools equal page for page."""
    jm, jp, tm, tp = models
    k = 3
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [7, 8, 0, 0],
                      [0, 0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(4, 9, 4, 16, kv_quant=kv_quant)
    _, (vt, vp, sidx, nd), jcache = _verify_inputs(jm, jp, jcache, table,
                                                   k + 1)
    # row 1 becomes a tree: a wrong first token at node 1, and the
    # target's own token as a depth-1 alternate at node 3 (in-row 3)
    good = int(vt[1, 1])
    vt[1, 1:4] = [(good + 1) % 512, 5, good]
    vp[1, :4] = np.arange(6, 10)
    nd[1] = 3
    rpos = vp.copy()
    rpos[1, :4] = [6, 7, 8, 7]
    parents = np.full((4, 8), -1, np.int32)
    parents[0, 1:k + 1] = np.arange(k)
    parents[1, 1:4] = [0, 1, 0]
    amask = np.broadcast_to(np.tril(np.ones((8, 8), bool)), (4, 8, 8)).copy()
    amask[1] = False
    amask[1, :4, :4] = [[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 0],
                        [1, 0, 0, 1]]
    tcache = bridge.paged_cache_to_torch(_np_tree(jcache), device="cpu")
    jeng = JEngine(jm, jp, max_seq=16, page_size=4, spec_decode="ngram",
                   spec_k=k, spec_tree=True)
    fix, n_acc, path, jcache = jeng._tree_greedy_fn(
        jp, jcache, jnp.asarray(table), jnp.asarray(vt), jnp.asarray(vp),
        jnp.arange(4, dtype=jnp.int32), jnp.asarray(sidx), jnp.asarray(nd),
        jnp.asarray(rpos), jnp.asarray(amask), jnp.asarray(parents))
    teng = GenerationEngine(tm, tp, max_seq=16, page_size=4,
                            spec_decode="ngram", spec_k=k, spec_tree=True)
    teng._paged_cache = tcache
    tfix, tn, tpath, moved = teng._tree_greedy(*(torch.from_numpy(a) for a in (
        table, vt, vp, sidx, nd, rpos, amask, parents)))
    live = [0, 1, 2]
    for a, b in ((tfix, fix), (tn, n_acc), (tpath, path)):
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])
    assert list(tn.numpy()[:3]) == [k, 1, 0] and int(tpath[1, 0]) == 3
    assert int(moved[1]) == 1
    if kv_quant == "int8":
        _assert_pools_equal(tcache, _np_tree(jcache), scale_rtol=2e-5)
