"""Port serving engine: greedy streams ≡ the port's own `generate()`,
pager state ≡ the JAX package's pager, invalid options raise (the
one-shot path and parallel sampling: `test_torch_oneshot.py`; meshes:
`test_torch_tp_serving.py`).

JAX engine streams are not used as an oracle (seven JAX identity tests
are red on this tree); the port is held against itself, as the
reference's identity checks hold the reference against itself, and its
host pager against the JAX one op for op.

The identity runs with the reference's bf16 activations (and f32
quantized compute): K/V are then bf16 in both paths before anyone
attends over them. With f32 activations the two differ by design —
`generate`'s prefill attends over the prompt's f32 K/V, while every
engine step reads K/V back from bf16 pages — and a near-tied argmax can
go either way.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import kv_pager as jkv
from repro_torch.configs import qwen25_05b
from repro_torch.core.pipeline import quantize_params
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.distributed.sharding import Mesh
from repro_torch.models.model import Model
from repro_torch.serving import engine as eng_mod
from repro_torch.serving import kv_pager as tkv
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
    cfg = dataclasses.replace(qwen25_05b.smoke_config(), num_heads=14,
                              num_kv_heads=2)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    return m, {"float": p, "awq": quantize_params(p)[0]}


@pytest.mark.parametrize("kind", ["float", "awq"])
@pytest.mark.parametrize("chunk", [4, 16])
def test_greedy_streams_match_generate(model_params, kind, chunk):
    m, params = model_params
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        eng = GenerationEngine(m, params[kind], max_seq=64, num_slots=3,
                               page_size=8, prefill_chunk=chunk)
        rng = np.random.default_rng(chunk)
        prompts = [rng.integers(0, 512, n).astype(np.int32)
                   for n in (5, 17, 9, 1, 24)]
        news = [8, 5, 12, 6, 7]
        rids = [eng.submit(p, n) for p, n in zip(prompts, news)]
        out = eng.drain()
        assert eng.idle and eng.num_active == 0
        for rid, p, n in zip(rids, prompts, news):
            ref = eng.generate({"tokens": p[None]}, n)[0]
            np.testing.assert_array_equal(out[rid], ref)
    st = eng.stats()
    assert st.pager.pages_used == 0 and st.dispatches > 0
    assert st.prefill_tokens == sum(len(p) for p in prompts)


def test_int8_pool_stream_is_deterministic_and_step_api(model_params):
    m, params = model_params
    runs = []
    for _ in range(2):
        eng = GenerationEngine(m, params["awq"], max_seq=32, num_slots=2,
                               page_size=8, kv_quant="int8")
        rids = [eng.submit(np.arange(n, dtype=np.int32) + 3, 6)
                for n in (7, 11)]
        events = []
        while not eng.idle:
            events += eng.step()
        out = eng.collect()
        assert sorted(out) == rids
        assert len(events) == 12
        assert all(len(out[r]) == 6 for r in rids)
        runs.append(out)
    for r in runs[0]:
        np.testing.assert_array_equal(runs[0][r], runs[1][r])


def test_sample_batched_greedy_rows_are_argmax():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7])
    topks = torch.tensor([0, 5, 3, 0], dtype=torch.int32)
    out = eng_mod.sample_batched(logits, temps, topks,
                                 torch.Generator().manual_seed(1))
    greedy = eng_mod.sample(logits, SamplerConfig())
    assert out.dtype == torch.int32
    assert out[0] == greedy[0] and out[2] == greedy[2]
    top5 = torch.topk(logits[1], 5).indices
    assert out[1] in top5


def test_sampled_distribution_matches_softmax():
    """jax.random and torch draw different bits: compare distributions."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = eng_mod.sample(logits, SamplerConfig(temperature=1.0), gen)
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], 0).numpy(),
                               atol=0.03)
    topk = eng_mod.sample(logits, SamplerConfig(temperature=1.0, top_k=2),
                          gen)
    assert set(np.unique(topk.numpy())) <= {0, 1}


def _pager_state(p):
    return dict(tables=p.page_tables.tolist(), ref=p.page_ref.tolist(),
                free_pages=list(p.free_pages), free_slots=list(p.free_slots),
                slot_pages={k: list(v) for k, v in p.slot_pages.items()},
                slot_len=p.slot_len.tolist(),
                reserved=dict(p.slot_reserved),
                committed=dict(p.slot_committed), version=p.version,
                stats=dataclasses.asdict(p.stats()),
                spills={i: (r.layout, r.spilled_pages, r.slot_len,
                            r.committed, r.reserved)
                        for i, r in p.spill_records.items()},
                pins={k: sorted(v) for k, v in p._pin_pages.items()},
                index=dict(p.prefix_index))


def test_pager_replay_matches_jax():
    cfg = dict(num_pages=24, page_size=4, num_slots=4, pages_per_slot=6)
    pagers = [jkv.KVPager(jkv.PagerConfig(**cfg)),
              tkv.KVPager(tkv.PagerConfig(**cfg))]
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 50, 8).astype(np.int32)
    done = np.zeros(8, int)           # successful ops by kind (7: restore)
    parked: list[tuple] = []          # (jax record, port record) pairs
    for _ in range(400):
        op = rng.integers(0, 7)
        active = sorted(pagers[0].slot_pages)
        if op == 0:
            plen = int(rng.integers(1, 14))
            toks = np.concatenate([prefix, rng.integers(0, 50, plen)])
            new = int(rng.integers(1, 8))
            if not pagers[0].fits(len(toks), new):
                continue
            if not pagers[0].can_admit(len(toks), new):
                assert not pagers[1].can_admit(len(toks), new)
                continue
            res = []
            for p in pagers:
                shared = p.match_prefix(toks, "sys")
                slot, _ = p.alloc_slot(len(toks), new, shared_pages=shared)
                p.commit_chunk(slot, 0, len(toks))
                res.append((slot, p.register_prefix(slot, toks, "sys")))
            assert res[0] == res[1]
        elif active and op == 1:
            slot = active[int(rng.integers(len(active)))]
            cap = (pagers[0].slot_reserved[slot]
                   + len(pagers[0].slot_pages[slot])) * cfg["page_size"]
            new_len = min(cap, int(pagers[0].slot_len[slot])
                          + int(rng.integers(1, 6)))
            for p in pagers:
                p.extend(slot, new_len)
        elif active and op == 2:
            slot = active[int(rng.integers(len(active)))]
            plen = pagers[0].slot_committed[slot]
            back = max(plen, int(pagers[0].slot_len[slot])
                       - int(rng.integers(0, 4)))
            assert pagers[0].truncate(slot, back) == \
                pagers[1].truncate(slot, back)
        elif active and op == 3:
            slot = active[int(rng.integers(len(active)))]
            for p in pagers:
                p.free_slot(slot)
        elif op == 4 and (active or parked):
            # preemption tier: spill an active slot, or restore one
            if parked and (not active or rng.integers(2)):
                recs = parked[int(rng.integers(len(parked)))]
                if not pagers[0].can_restore(recs[0]):
                    assert not pagers[1].can_restore(recs[1])
                    continue
                parked.remove(recs)
                res = [p.restore(r) for p, r in zip(pagers, recs)]
                assert res[0] == res[1]
                op = 7
            else:
                slot = active[int(rng.integers(len(active)))]
                assert pagers[0].peek_spill(slot) == \
                    pagers[1].peek_spill(slot)
                parked.append(tuple(p.spill(slot) for p in pagers))
        elif op == 5:
            pin = bool(rng.integers(2))
            assert len({p.pin_prefix("sys") if pin else p.unpin_prefix("sys")
                        for p in pagers}) == 1
        elif active:
            # handoff tier: export a slot, release it, adopt it back
            slot = active[int(rng.integers(len(active)))]
            new = int(rng.integers(1, 4))
            recs = []
            for p in pagers:
                rec, ids = p.export_slot(slot)
                assert ids == p.slot_pages[slot]
                p.free_slot(slot)
                recs.append(rec)
            if not pagers[0].can_adopt(recs[0], new):
                assert not pagers[1].can_adopt(recs[1], new)
            else:
                res = [p.adopt(r, new) for p, r in zip(pagers, recs)]
                assert res[0] == res[1]
        else:
            continue
        done[op] += 1
        assert _pager_state(pagers[1]) == _pager_state(pagers[0])
        pagers[1].verify_invariants()
    assert (done >= 5).all(), done


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(spec_decode="medusa"), ValueError, "unknown spec_decode"),
    (dict(spec_tree=True), ValueError, "spec_tree needs a drafter"),
    (dict(spec_decode="draft_model"), ValueError,
     "spec_decode='draft_model' needs draft_model"),
    (dict(spec_decode="ngram", spec_tree=True, spec_tree_fanout=0),
     ValueError, "spec_tree_fanout must be"),
    (dict(spec_decode="ngram", chunked_prefill=False), ValueError,
     "spec_decode requires the chunked serving path"),
    (dict(mesh=Mesh(["cpu", "cpu"], ("data",))), ValueError,
     "'model' axis"),
    (dict(preemption=True, chunked_prefill=False), ValueError, "chunked"),
    (dict(admission="optimistic"), ValueError, "optimistic"),
    (dict(admission="yolo"), ValueError, "admission")],
    ids=["spec_decode", "spec_tree", "draft", "spec_tree_fanout",
         "spec_oneshot", "mesh", "preemption", "optimistic",
         "unknown_admission"])
def test_unported_engine_options_raise(model_params, kwargs, exc, match):
    """Speculation, meshes, preemption and optimistic admission keep the
    reference's checks and messages: an unknown drafter, a tree without a
    drafter, draft mode without a model, a zero fanout, speculation or
    preemption off the chunked path (raised when serving starts, at the
    first `submit`), a mesh without a ``model`` axis (the rest of the
    mesh checks: `tests/test_torch_tp_serving.py`), optimistic admission
    without preemption and an unknown admission policy are refused."""
    m, params = model_params
    with pytest.raises(exc, match=match):
        eng = GenerationEngine(m, params["float"], max_seq=32, **kwargs)
        eng.submit(np.arange(4, dtype=np.int32), 4)
