"""The engine's one-shot path, held against the port itself and the JAX
package: one-shot streams ≡ chunked streams ≡ the port's own `generate()`
over bf16 pools (JAX serving streams are not an oracle: seven JAX
identity tests are red on this tree), and with shared prefixes the
integers (stats) equal to the JAX engine's for the same submits.
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


# -------------------------------------------------------- one-shot engine

def _serve(m, params, prompts, new, **kw):
    kw = {"max_seq": 64, "num_slots": 4, "page_size": 8, **kw}
    eng = GenerationEngine(m, params, **kw)
    rids = [eng.submit(p, new) for p in prompts]
    out = eng.drain()
    assert eng._scheduler.pager.pages_in_use == 0
    return [list(out[r]) for r in rids], eng


PROMPT_LENS = (5, 12, 9, 17, 7, 21)


@pytest.fixture(scope="module")
def oneshot_run(port_model):
    """The one-shot engine's streams for the chunk cases below, and the
    port's `generate()` stream of each prompt: both independent of the
    chunk, so run once for all four cases."""
    m, params = port_model
    prompts = _prompts(m.cfg.vocab_size, PROMPT_LENS, 1)
    with execution_config(F32):
        oneshot, eng_o = _serve(m, params["awq"], prompts, 8,
                                chunked_prefill=False)
        refs = [eng_o.generate({"tokens": p[None]}, 8)[0].tolist()
                for p in prompts]
    return prompts, oneshot, eng_o, refs


@pytest.mark.parametrize("chunk", [8, 3, 5, 64])
def test_oneshot_matches_chunked_and_generate(port_model, oneshot_run,
                                              chunk):
    """The reference's `test_chunked_matches_oneshot_and_generate` on the
    port (page 8: an aligned chunk, two unaligned, one past the prompt)."""
    m, params = port_model
    prompts, oneshot, eng_o, refs = oneshot_run
    chunked, eng_c = _serve(m, params["awq"], prompts, 8,
                            prefill_chunk=chunk)
    assert chunked == oneshot
    assert eng_c._scheduler.chunked and not eng_o._scheduler.chunked
    assert eng_c.stats().prefill_tokens == sum(map(len, prompts))
    # the reference counts prompt tokens on the chunked path only
    assert eng_o.stats().prefill_tokens == 0
    assert eng_o.warmup() == 0 and eng_c.warmup() > 0
    for stream, ref in zip(oneshot, refs):
        np.testing.assert_array_equal(stream, ref)


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
