"""Port parity: the sliding-window ring decode cache on gemma3-4b's smoke
config (7 layers, window 32 on every layer but each third, RoPE theta
10k on the windowed layers and 1M on the global ones), against the
reference.

  * `_ring_positions` equal to the reference's;
  * `generate()`'s path (`Model.prefill` into a ring of min(window, S)
    slots, then `Model.decode_step` writing slot ``pos % window``) for
    prompts below, at and above the window, decoding across the ring's
    wrap: logits at the reference's f32 tolerance (rtol/atol 2e-5,
    `tests/test_kernels.py:40`; f32 activations and an f32 cache on both
    sides, so only the order of the sums differs), every ring slot equal
    (f32 values and scale strips at rtol 2e-5; int8 codes within one
    code, and fewer than 1 in 1,000 off by one: the values entering the
    codec carry the frameworks' sum-order difference, so one that sits on
    a rounding midpoint may take the neighbouring code). Over an int8
    cache the decode logits, and the scale strips decode writes, are held
    at rtol/atol 1e-3: a code one off moves the logits by up to 2e-4
    (measured), and the K/V computed from them drift as far;
  * the one-shot engine's commit of a windowed prefill into the page
    pools: the reference commits the ring's slots as they lie
    (`repro/serving/kv_pager.py:998-1004`), so for a prompt longer than
    the window the pages hold the ring's slot order and the positions
    past the window stay unwritten; the port's pools must equal the
    reference's byte for byte either way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as jcfgs
from repro.core import qlinear as jql
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serving import kv_pager as jkv
from repro_torch import bridge
from repro_torch.configs import gemma3_4b as tcfgs
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model
from repro_torch.serving import kv_pager as tkv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


F32 = dict(rtol=2e-5, atol=2e-5)
INT8 = dict(rtol=1e-3, atol=1e-3)
WINDOW = 32
MAX_SEQ = 64


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _cfg(mod, kv_quant):
    return dataclasses.replace(mod.smoke_config(), activation_dtype="float32",
                               kv_quant=kv_quant)


@pytest.fixture(scope="module")
def params():
    jp = jbuild(_cfg(jcfgs, "none")).init(jax.random.PRNGKey(0))
    return jp, bridge.params_to_torch(_np(jp), device="cpu")


@pytest.fixture(autouse=True)
def f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        yield


def test_config_interleaves_windowed_and_global_layers():
    kinds = tcfgs.smoke_config().layer_kinds()
    assert [k.window for k in kinds] == [WINDOW, WINDOW, 0] * 2 + [WINDOW]
    assert tcfgs.config().sliding_window == 1024


@pytest.mark.parametrize("w", [1, 5, 32])
def test_ring_positions_match_reference(w):
    pos = np.array([0, 1, w - 1, w, w + 3, 3 * w + 2, 100], np.int32)
    got = tattn._ring_positions(torch.from_numpy(pos), w).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jattn._ring_positions(jnp.asarray(pos), w)))


def _ring_leaves(cache):
    """{(segment, layer): leaves} of every windowed layer's ring."""
    out = {}
    for seg, layers in cache.items():
        for i, entry in enumerate(layers):
            if entry["kv"]["k"].shape[1] == WINDOW:
                out[seg, i] = entry["kv"]
    return out


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("prompt_len", [20, 32, 45],
                         ids=["below", "at", "above"])
def test_ring_prefill_and_decode_across_the_wrap(params, prompt_len,
                                                 kv_quant):
    """Prefill 2 prompts, then greedy decode steps past position 40, which
    every prompt length crosses the ring's wrap (32) with; logits and the
    ring slots of every windowed layer after each phase."""
    jp, tp = params
    jm, tm = jbuild(_cfg(jcfgs, kv_quant)), Model(_cfg(tcfgs, kv_quant))
    toks = np.random.default_rng(prompt_len).integers(
        0, 512, (2, prompt_len)).astype(np.int32)
    jc = jm.init_cache(2, MAX_SEQ, dtype=jnp.float32)
    tc = tm.init_cache(2, MAX_SEQ, dtype=torch.float32, device="cpu")
    assert len(_ring_leaves(tc)) == 5
    jc, jl, jpos = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    decode = jax.jit(jm.decode_step)
    steps = max(4, 41 - prompt_len)

    def rings_equal(drift: bool):
        """Ring slots equal; after int8 decode steps (``drift``) the
        values written carry the logits' drift above: codes within one,
        scale strips at the int8 logits' tolerance."""
        jring = _ring_leaves(bridge.paged_cache_to_torch(_np(jc),
                                                         device="cpu"))
        for key, leaves in _ring_leaves(tc).items():
            for name, t in leaves.items():
                ref = jring[key][name].numpy()
                if t.dtype == torch.int8:
                    diff = np.abs(t.numpy().astype(int) - ref)
                    assert diff.max() <= 1
                    assert drift or diff.mean() < 1e-3
                elif name in ("ks", "vs"):
                    np.testing.assert_allclose(
                        t.numpy(), ref, **(INT8 if drift else dict(
                            rtol=2e-5, atol=0)))
                else:
                    np.testing.assert_allclose(t.numpy(), ref, **F32)

    rings_equal(drift=False)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(nxt), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **(F32 if kv_quant == "none" else INT8))
    assert int(tpos.min()) > 40
    rings_equal(drift=kv_quant == "int8")


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("prompt_len", [20, 45], ids=["below", "above"])
def test_oneshot_commit_of_a_windowed_prefill_matches_reference(
        params, prompt_len, kv_quant):
    """The reference's dense prefill cache (rings of min(32, S) on the
    windowed layers), committed by both packages into pools of pages of 8
    that hold stale bytes: the pools must be equal."""
    jp, _ = params
    jm = jbuild(_cfg(jcfgs, "none"))
    page = 8
    toks = np.random.default_rng(7).integers(0, 512, (1, prompt_len)).astype(
        np.int32)
    pre = jm.init_cache(1, prompt_len)
    pre, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, pre)
    n_pages = -(-prompt_len // page)
    pages = np.arange(2, 2 + n_pages, dtype=np.int32)
    jpool = jm.init_paged_cache(2, 12, page, MAX_SEQ, kv_quant=kv_quant)
    rng = np.random.default_rng(8)
    jpool = jax.tree_util.tree_map(      # stale bytes from an earlier slot
        lambda a: jnp.asarray(rng.integers(-100, 100, a.shape).astype(
            a.dtype)), jpool)
    tpool = bridge.paged_cache_to_torch(_np(jpool), device="cpu")
    stale = bridge.paged_cache_to_torch(_np(jpool), device="cpu")
    tpre = bridge.paged_cache_to_torch(_np(pre), device="cpu")
    jpool = jkv.commit_prefill(jpool, pre, jnp.int32(0), jnp.asarray(pages),
                               page_size=page)
    tkv.commit_prefill(tpool, tpre, 0, pages.tolist(), page_size=page)
    ref = bridge.paged_cache_to_torch(_np(jpool), device="cpu")
    for seg, layers in tpool.items():
        for i, entry in enumerate(layers):
            for name, t in entry["kv_pool"].items():
                torch.testing.assert_close(
                    t, ref[seg][i]["kv_pool"][name], rtol=0, atol=0)

    def positions(tree, seg):          # the slot's positions, in order
        k = tree[seg][0]["kv_pool"]["k"]
        return k[torch.from_numpy(pages).long()].flatten(0, 1)

    # a windowed layer wrote its ring's min(32, S) slots, a global one all
    # S positions; the rest keep the stale bytes
    written = {"seg_0": min(WINDOW, prompt_len), "seg_1": prompt_len}
    for seg, n in written.items():
        new, old = positions(tpool, seg), positions(stale, seg)
        assert not torch.equal(new[:n], old[:n])
        assert torch.equal(new[n:], old[n:])
