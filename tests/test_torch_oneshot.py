"""The one-shot serving path's parts, held against the JAX package.

  * `commit_prefill` against the reference's on the same dense prefill
    cache and pool: bf16 pages and int8 codes equal, f32 scale strips at
    rtol 2e-5;
  * `Model.decode_step(page_table=...)` logits against the reference's,
    float and AWQ params over bf16 and int8 pools, at the reference's
    kernel tolerances (`tests/test_kernels.py:40`: rtol/atol 2e-5 where
    every cached value is f32 or int8, 2e-2 over bf16 pages);
  * the engine's first token, which `Model.prefill` gives before any
    pool is read, against JAX's prefill over either pool type.

The engine's streams (one-shot ≡ chunked ≡ `generate()`) are in
`tests/test_torch_oneshot_streams.py`; parallel sampling and
`generate_scan` in `tests/test_torch_parallel.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen25_05b as jcfgs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.models import build_model as jbuild
from repro.serving import kv_pager as jkv
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.models.model import Model
from repro_torch.serving import kv_pager as tkv
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
    pool["seg_0"][0] = {"mystery": pool["seg_0"][0]["kv_pool"]}
    with pytest.raises(ValueError, match="unknown cache entry"):
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


# ------------------------------------------------------ the first token

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
