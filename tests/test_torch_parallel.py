"""Parallel sampling (`submit(n)`) and `generate_scan` on the port: greedy
siblings equal the port's `generate()` and share the prompt's pages, the
integers equal the JAX engine's, sampled siblings are distributed like
independent runs, and `generate_scan` equals `generate`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import qlinear as jql
from repro.models import build_model as jbuild
from repro.serving import GenerationEngine as JEngine
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core.pipeline import quantize_params
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.models.model import Model
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


F32 = ExecutionConfig(compute_dtype=torch.float32)


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
