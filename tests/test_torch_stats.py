"""The port's `EngineStats` against the JAX engine's.

The field names and their order equal the reference's, for `EngineStats`
and `SchedulerStats`. Values: the same submits go through the JAX engine
and the port's engine on the same (bridged) params, float and AWQ-packed,
over bf16 and int8 pools, on the chunked and the one-shot path, and
`stats()` must be equal after every step (ints exact, floats rel 1e-6).
With ``eos_id = -1`` the schedule does not depend on token values, so the
integers are comparable although JAX serving streams are not an oracle
on this tree (seven JAX identity tests are red).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.serving import GenerationEngine as JEngine
from repro.serving import engine as jeng_mod
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import qwen25_05b
from repro_torch.models.model import Model
from repro_torch.serving import engine as teng_mod
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


@pytest.fixture(scope="module")
def pair():
    """(jax model, port model, {"float" | "awq": (jax params, port params)})"""
    jm = jbuild(jconfigs.get_smoke_config("qwen25-05b"))
    tm = Model(qwen25_05b.smoke_config())
    jp = jm.init(jax.random.PRNGKey(0))
    out = {}
    for name, p in (("float", jp), ("awq", jpipe.quantize_params(jp)[0])):
        out[name] = (p, bridge.params_to_torch(
            jax.tree_util.tree_map(np.asarray, p), device="cpu"))
    return jm, tm, out


def _names(cls):
    return [f.name for f in dataclasses.fields(cls)]


def test_stats_fields_and_order_match_reference():
    assert _names(teng_mod.EngineStats) == _names(jeng_mod.EngineStats)
    assert _names(tsched.SchedulerStats) == _names(jsched.SchedulerStats)
    for f in ("acceptance_rate", "spec_tokens_per_row", "padding_waste"):
        assert hasattr(tsched.SchedulerStats, f)


def _snapshot(st):
    return {f.name: (dataclasses.asdict(getattr(st, f.name))
                     if f.name == "pager" else getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _assert_stats_equal(port, ref):
    a, b = _snapshot(port), _snapshot(ref)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=0), k
        else:
            assert a[k] == b[k], k


def _workload(vocab):
    """Two requests sharing a 16-token prefix, two unshared ones, ragged
    prompts and budgets: every counter of a run moves."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, 16).astype(np.int32)
    reqs = [(np.concatenate([prefix, rng.integers(0, vocab, t).astype(
        np.int32)]), new, "sys") for t, new in ((3, 4), (7, 6))]
    reqs += [(rng.integers(0, vocab, n).astype(np.int32), new, None)
             for n, new in ((5, 7), (13, 3))]
    return reqs


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked",
                                                         "one_shot"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_stats_values_match_jax_engine(pair, kind, kv_quant, chunked):
    jm, tm, params = pair
    jp, tp = params[kind]
    kw = dict(max_seq=64, num_slots=3, page_size=8, prefill_chunk=8,
              kv_quant=kv_quant, chunked_prefill=chunked)
    port, ref = GenerationEngine(tm, tp, **kw), JEngine(jm, jp, **kw)
    before = port.paged_kv_page_bytes()
    assert port._scheduler is None            # nothing allocated
    assert before == ref.paged_kv_page_bytes()
    _assert_stats_equal(port.stats(), ref.stats())
    assert port._scheduler is None
    for toks, new, pid in _workload(tm.cfg.vocab_size):
        assert port.submit(toks, new, prefix_id=pid) == \
            ref.submit(toks, new, prefix_id=pid)
    assert port.paged_kv_page_bytes() == before
    steps = 0
    while not ref.idle:
        ev_p, ev_r = port.step(), ref.step()
        assert [r for r, _ in ev_p] == [r for r, _ in ev_r]
        _assert_stats_equal(port.stats(), ref.stats())
        steps += 1
    assert port.idle and steps > 3
    _assert_stats_equal(port.stats(), ref.stats())
    st = port.stats()
    assert st.prefix_shared_pages == 2 and st.pager.pages_used == 0
    assert (st.prefill_tokens > 0) == chunked
    assert port.scheduler_stats is port._scheduler.stats
    assert port.scheduler_stats.admitted == 4 == ref.scheduler_stats.admitted


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_page_bytes_before_serving_allocate_nothing(pair, kv_quant):
    """`paged_kv_page_bytes` reckons a fresh engine's page from shapes on
    the meta device; serving later allocates exactly that page size."""
    _, tm, params = pair
    eng = GenerationEngine(tm, params["float"][1], max_seq=32, num_slots=2,
                           page_size=8, kv_quant=kv_quant, num_pages=7)
    page = eng.paged_kv_page_bytes()
    assert eng._scheduler is None and eng._paged_cache is None
    cfg = tm.cfg
    per_tok = 2 * cfg.num_kv_heads * cfg.head_dim * (
        1 if kv_quant == "int8" else 2) + (
        2 * cfg.num_kv_heads * 4 if kv_quant == "int8" else 0)
    assert page == cfg.num_layers * 8 * per_tok
    assert eng.paged_kv_bytes_per_token() == page / 8
    eng.submit(np.arange(5, dtype=np.int32), 2)
    assert eng.stats().kv_pool_bytes == 7 * page
    assert eng.paged_kv_page_bytes() == page
    eng.drain()


def test_weight_bytes_per_token_is_one_weight_pass(pair):
    _, tm, params = pair
    for kind in ("float", "awq"):
        eng = GenerationEngine(tm, params[kind][1], max_seq=32)
        st = eng.stats()
        assert st.weight_bytes == eng.weight_stream_bytes() > 0
        assert st.weight_bytes_per_token == st.weight_bytes
        assert eng.weight_bytes_per_token(2.0) == st.weight_bytes / 2
        assert (st.spec_k_now, st.spec_fanout_now, st.model_axis) == (4, 1, 1)
    assert (GenerationEngine(tm, params["awq"][1]).weight_stream_bytes()
            < GenerationEngine(tm, params["float"][1]).weight_stream_bytes())
