"""The one-shot serving path, parallel sampling and `generate_scan`,
held against the JAX package and against the port itself.

  * `commit_prefill` against the reference's on the same dense prefill
    cache and pool: bf16 pages and int8 codes equal, f32 scale strips at
    rtol 2e-5;
  * `Model.decode_step(page_table=...)` logits against the reference's,
    float and AWQ params over bf16 and int8 pools, at the reference's
    kernel tolerances (`tests/test_kernels.py:40`: rtol/atol 2e-5 where
    every cached value is f32 or int8, 2e-2 over bf16 pages);
  * the engine: one-shot streams ≡ chunked streams ≡ the port's own
    `generate()` over bf16 pools (JAX serving streams are not an oracle:
    seven JAX identity tests are red on this tree), and integers (stats,
    pager state) equal to the JAX engine's for the same submits. Over
    int8 pools one-shot and chunked differ by design (the one-shot
    prefill attends over the dense bf16 cache and quantizes on commit),
    so there only the first token, which no pool has touched yet, is
    held against JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import qwen25_05b as jcfgs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.models import build_model as jbuild
from repro.serving import GenerationEngine as JEngine
from repro.serving import kv_pager as jkv
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core.pipeline import quantize_params
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.models.model import Model
from repro_torch.serving import kv_pager as tkv
from repro_torch.serving.engine import GenerationEngine, SamplerConfig

TOL_F32 = dict(rtol=2e-5, atol=2e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = ExecutionConfig(compute_dtype=torch.float32)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def parity():
    """f32 activations, Qwen2.5's grouping (14 q / 2 kv heads): (jax model,
    port model, {"float" | "awq": (jax params, port params)})."""
    kw = dict(num_heads=14, num_kv_heads=2, activation_dtype="float32")
    jm = jbuild(dataclasses.replace(jcfgs.smoke_config(), **kw))
    tm = Model(dataclasses.replace(tcfgs.smoke_config(), **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    out = {}
    for name, p in (("float", jp), ("awq", jpipe.quantize_params(jp)[0])):
        out[name] = (p, bridge.params_to_torch(_np_tree(p), device="cpu"))
    return jm, tm, out


@pytest.fixture(autouse=True)
def f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with execution_config(F32):
        yield


@pytest.fixture(scope="module")
def port_model():
    """The port alone, bf16 activations (the engine identity runs)."""
    cfg = dataclasses.replace(tcfgs.smoke_config(), num_heads=14,
                              num_kv_heads=2)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    return m, {"float": p, "awq": quantize_params(p)[0]}


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------- commit

@pytest.mark.parametrize("s", [16, 13], ids=["aligned", "ragged"])
@pytest.mark.parametrize("start_page", [0, 1])
@pytest.mark.parametrize("regime", ["bf16", "int8", "int8_prefill"])
def test_commit_prefill_matches_jax(parity, regime, start_page, s):
    """bf16 pool ← bf16 prefill; int8 pool ← bf16 prefill (quantize on
    commit); bf16 pool ← int8 prefill (dequantize on commit)."""
    jm = parity[0]
    cfg = jm.cfg
    lyr, hkv, hd, page = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 8
    rng = np.random.default_rng(s + start_page)
    shape = (lyr, 1, s, hkv, hd)
    if regime == "int8_prefill":
        pre = {k: jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
               for k in ("k", "v")}
        pre.update({k: jnp.asarray(rng.uniform(0.01, 0.1, shape[:-1]),
                                   jnp.float32) for k in ("ks", "vs")})
    else:
        pre = {k: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
               for k in ("k", "v")}
    pre = {"seg_0": {"kv": pre}}
    kv_quant = "int8" if regime == "int8" else "none"
    jpool = jm.init_paged_cache(2, 9, page, 32, kv_quant=kv_quant)
    # pages already holding an aliased prefix (and stale bytes elsewhere)
    jpool = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(-1, 1, a.shape) * 50, a.dtype),
        jpool)
    pages = [5, 2, 7]
    tpool = bridge.paged_cache_to_torch(_np_tree(jpool), device="cpu")
    tpre = bridge.paged_cache_to_torch(_np_tree(pre), device="cpu")
    jout = _np_tree(jkv.commit_prefill(jpool, pre, jnp.int32(1),
                                       jnp.asarray(pages, jnp.int32),
                                       page_size=page,
                                       start_page=start_page))
    tout = tkv.commit_prefill(tpool, tpre, 1, pages, page_size=page,
                              start_page=start_page)
    assert tout is tpool                      # pools update in place
    for i, layer in enumerate(tout["seg_0"]):
        for key, got in layer["kv_pool"].items():
            ref = jout["seg_0"]["kv_pool"][key][i]
            if key in ("ks", "vs"):
                np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)
            else:
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(ref, np.float32))
    stale = np.asarray(_np_tree(jpool)["seg_0"]["kv_pool"]["k"][0],
                       np.float32)
    first = tout["seg_0"][0]["kv_pool"]["k"][pages[0]].float().numpy()
    # an aliased page keeps its bytes; a committed one takes the prefill's
    assert np.array_equal(first, stale[pages[0]]) == bool(start_page)


def test_commit_prefill_refuses_unported_entries(parity):
    _, tm, params = parity
    pool = tm.init_paged_cache(4, 8, device="cpu")
    pre = tm.init_cache(1, 8, device="cpu")
    pool["seg_0"][0] = {"kv": pool["seg_0"][0]["kv_pool"]}
    with pytest.raises(NotImplementedError, match="not ported"):
        tkv.commit_prefill(pool, pre, 0, [1], page_size=8)


# ---------------------------------------------------------- paged decode

@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_decode_step_paged_matches_jax(parity, kind, kv_quant):
    """Two prompts prefilled and committed (JAX), the pool bridged, then
    four paged decode steps over 3 slots (slot 2 idle on the scratch
    page) on both sides."""
    jm, tm, params = parity
    jp, tp = params[kind]
    tol = TOL_F32 if kv_quant == "int8" else TOL_BF16
    page = 8
    table = np.array([[3, 5, 0, 0], [1, 2, 6, 0], [0, 0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(3, 9, page, 32, kv_quant=kv_quant)
    toks, pos = [], np.zeros(3, np.int32)
    for slot, toks_p in enumerate(_prompts(jm.cfg.vocab_size, (9, 14), 4)):
        pre = jm.init_cache(1, len(toks_p))
        pre, lg, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks_p)[None]},
                                pre)
        jcache = jkv.commit_prefill(jcache, pre, jnp.int32(slot),
                                    jnp.asarray(table[slot]),
                                    page_size=page)
        toks.append(int(jnp.argmax(lg[0])))
        pos[slot] = len(toks_p)
    toks = np.array(toks + [0], np.int32)
    tcache = bridge.paged_cache_to_torch(_np_tree(jcache), device="cpu")
    for _ in range(4):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks),
                                    jnp.asarray(pos),
                                    page_table=jnp.asarray(table))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks),
                                    torch.from_numpy(pos),
                                    page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **tol)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        toks[2] = 0
        pos[:2] += 1


# -------------------------------------------------------- one-shot engine

def _serve(m, params, prompts, new, **kw):
    kw = {"max_seq": 64, "num_slots": 4, "page_size": 8, **kw}
    eng = GenerationEngine(m, params, **kw)
    rids = [eng.submit(p, new) for p in prompts]
    out = eng.drain()
    assert eng._scheduler.pager.pages_in_use == 0
    return [list(out[r]) for r in rids], eng


@pytest.mark.parametrize("chunk", [8, 3, 5, 64])
def test_oneshot_matches_chunked_and_generate(port_model, chunk):
    """The reference's `test_chunked_matches_oneshot_and_generate` on the
    port (page 8: an aligned chunk, two unaligned, one past the prompt)."""
    m, params = port_model
    prompts = _prompts(m.cfg.vocab_size, (5, 12, 9, 17, 7, 21), 1)
    chunked, eng_c = _serve(m, params["awq"], prompts, 8,
                            prefill_chunk=chunk)
    oneshot, eng_o = _serve(m, params["awq"], prompts, 8,
                            chunked_prefill=False)
    assert chunked == oneshot
    assert eng_c._scheduler.chunked and not eng_o._scheduler.chunked
    assert eng_c.stats().prefill_tokens == sum(map(len, prompts))
    # the reference counts prompt tokens on the chunked path only
    assert eng_o.stats().prefill_tokens == 0
    assert eng_o.warmup() == 0 and eng_c.warmup() > 0
    for p, stream in zip(prompts, oneshot):
        np.testing.assert_array_equal(
            stream, eng_o.generate({"tokens": p[None]}, 8)[0])


def test_oneshot_shared_prefix_identical_and_integers_match_jax(port_model):
    """The reference's `test_chunked_shared_prefix_identical_and_skips_
    flops`: chunks of 5 straddle page and prefix boundaries; shared ≡
    unshared ≡ one-shot streams, and the chunked run's integers equal the
    JAX engine's for the same submits."""
    m, params = port_model
    rng = np.random.default_rng(3)
    vocab = m.cfg.vocab_size
    prefix = rng.integers(0, vocab, (19,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, (t,)).astype(
        np.int32)]) for t in (6, 3, 9, 5)]
    kw = dict(max_seq=64, num_slots=4, page_size=8)

    def serve(eng, prefix_id):
        rids = [eng.submit(p, 6, prefix_id=prefix_id) for p in prompts]
        out = eng.drain()
        assert eng._scheduler.pager.pages_in_use == 0
        return [list(out[r]) for r in rids], eng.scheduler_stats

    shared, st_s = serve(GenerationEngine(m, params["float"],
                                          prefill_chunk=5, **kw), "sys")
    unshared, st_u = serve(GenerationEngine(m, params["float"],
                                            prefill_chunk=5, **kw), None)
    oneshot, st_o = serve(GenerationEngine(m, params["float"],
                                           chunked_prefill=False, **kw),
                          "sys")
    assert shared == unshared == oneshot
    assert st_s.prefix_shared_pages == 6
    assert st_s.prefill_tokens_skipped == 3 * 16
    assert st_u.prefill_tokens_skipped == 0
    assert st_s.prefill_tokens < st_u.prefill_tokens
    # one-shot: each follower aliases the 2 registered pages, nothing skips
    assert st_o.prefix_shared_pages == 6 and st_o.prefill_tokens_skipped == 0
    jm = jbuild(jconfigs.get_smoke_config("qwen25-05b"))
    jeng = JEngine(jm, jm.init(jax.random.PRNGKey(0)), prefill_chunk=5,
                   **kw)
    _, st_j = serve(jeng, "sys")
    assert dataclasses.asdict(st_s) == dataclasses.asdict(st_j)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_oneshot_first_token_matches_jax(parity, kv_quant):
    """The first token comes from `Model.prefill` before any pool is read:
    its logits equal JAX's prefill logits and the engine emits their
    argmax, over either pool type."""
    jm, tm, params = parity
    jp, tp = params["awq"]
    prompts = _prompts(jm.cfg.vocab_size, (6, 11, 16), 9)
    eng = GenerationEngine(tm, tp, max_seq=32, num_slots=2, page_size=8,
                           kv_quant=kv_quant, chunked_prefill=False)
    rids = [eng.submit(p, 3) for p in prompts]
    out = eng.drain()
    for rid, p in zip(rids, prompts):
        _, jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(p)[None]},
                              jm.init_cache(1, len(p)))
        _, tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(p)[None]},
                              tm.init_cache(1, len(p), device="cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_F32)
        top2 = np.sort(np.asarray(jl)[0])[-2:]
        assert top2[1] - top2[0] > 1e-3          # a clear argmax
        assert out[rid][0] == int(jnp.argmax(jl[0])) == int(tl[0].argmax())


# ----------------------------------------------------- parallel sampling

def test_parallel_greedy_identical_streams_and_page_sharing(port_model):
    """The reference's parallel-sampling case on the port: greedy n = 3
    siblings equal the port's `generate()`, the prompt's full pages are
    written once and aliased, and the integers equal the JAX engine's."""
    m, params = port_model
    prompt = _prompts(m.cfg.vocab_size, (20,), 7)[0]   # 2 full pages at 8
    kw = dict(max_seq=64, num_slots=4, page_size=8)
    eng = GenerationEngine(m, params["awq"], **kw)
    ref = eng.generate({"tokens": prompt[None]}, 8)[0]
    rids = eng.submit(prompt, 8, n=3)
    assert isinstance(rids, list) and len(rids) == 3
    peak_ref = 0
    while not eng.idle:
        eng.step()
        peak_ref = max(peak_ref, int(eng._scheduler.pager.page_ref.max()))
    out = eng.collect()
    for r in rids:
        np.testing.assert_array_equal(out[r], ref)
    assert peak_ref == 3                          # every sibling aliases
    st = eng.scheduler_stats
    assert st.prefix_shared_pages == 4            # 2 pages × 2 siblings
    assert st.prefill_tokens_skipped == 2 * 16
    assert eng._scheduler.pager.pages_in_use == 0
    eng._scheduler.pager.verify_invariants()
    jm = jbuild(jconfigs.get_smoke_config("qwen25-05b"))
    jeng = JEngine(jm, jm.init(jax.random.PRNGKey(0)), **kw)
    jrids = jeng.submit(prompt, 8, n=3)
    jeng.drain()
    assert jrids == rids
    assert dataclasses.asdict(jeng.scheduler_stats) == dataclasses.asdict(st)
    one = GenerationEngine(m, params["awq"], chunked_prefill=False, **kw)
    rids = one.submit(prompt, 8, n=3)
    out = one.drain()
    for r in rids:
        np.testing.assert_array_equal(out[r], ref)
    assert one.scheduler_stats.prefix_shared_pages == 4


def test_parallel_submit_shapes_and_validation(port_model):
    m, params = port_model
    eng = GenerationEngine(m, params["float"], max_seq=64, num_slots=4,
                           page_size=8)
    rid = eng.submit(np.arange(4, dtype=np.int32), 2)
    assert isinstance(rid, int)                   # n=1 keeps the scalar form
    with pytest.raises(ValueError, match="n must be"):
        eng.submit(np.arange(4, dtype=np.int32), 2, n=0)
    rids = eng.submit(np.arange(20, dtype=np.int32), 2, n=2,
                      prefix_id="sys")
    assert rids == [rid + 1, rid + 2]
    assert [r.prefix_id for r in eng._scheduler.queue][-2:] == ["sys"] * 2
    more = eng.submit(np.arange(20, dtype=np.int32), 2, n=2)
    assert [r.prefix_id for r in eng._scheduler.queue][-2:] == \
        [f"__par{more[0]}"] * 2
    eng.drain()
    assert eng._scheduler.pager.pages_in_use == 0


def test_parallel_sampled_marginals_match_independent_runs(port_model):
    """The first sampled token of `submit(n=2)` siblings is distributed
    like two independent single submissions (total-variation bound)."""
    m, params = port_model
    prompt = _prompts(m.cfg.vocab_size, (20,), 8)[0]
    samp = SamplerConfig(temperature=1.0, top_k=4)

    def first_tokens(n_mode, reps, seed):
        eng = GenerationEngine(m, params["float"], max_seq=64, num_slots=4,
                               page_size=8, seed=seed)
        firsts = []
        for _ in range(reps):
            if n_mode:
                rids = eng.submit(prompt, 1, sampler=samp, n=2)
            else:
                rids = [eng.submit(prompt, 1, sampler=samp)
                        for _ in range(2)]
            out = eng.drain()
            firsts += [int(out[r][0]) for r in rids]
        assert eng._scheduler.pager.pages_in_use == 0
        return firsts

    a = first_tokens(True, 40, seed=1)
    b = first_tokens(False, 40, seed=2)
    support = sorted(set(a) | set(b))
    assert len(support) <= 4                      # top_k bounds the support
    pa = np.array([a.count(t) for t in support], float) / len(a)
    pb = np.array([b.count(t) for t in support], float) / len(b)
    assert 0.5 * np.abs(pa - pb).sum() < 0.25     # TV distance, n=80 each
    assert len(set(a)) > 1                        # siblings draw apart


# ---------------------------------------------------------- generate_scan

@pytest.mark.parametrize("sampler", [SamplerConfig(),
                                     SamplerConfig(temperature=0.8,
                                                   top_k=5)],
                         ids=["greedy", "sampled"])
def test_generate_scan_equals_generate(port_model, sampler):
    m, params = port_model
    eng = GenerationEngine(m, params["awq"], max_seq=64, sampler=sampler)
    batch = {"tokens": np.stack(_prompts(m.cfg.vocab_size, (7, 7), 2))}
    got = eng.generate_scan(batch, 9, gen=torch.Generator().manual_seed(3))
    ref = eng.generate(batch, 9, gen=torch.Generator().manual_seed(3))
    assert got.shape == (2, 9) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
