"""Port parity: the Mamba-2 SSD mixer (`repro_torch.models.ssm`) against
the reference's `repro.models.ssm` and its block-level prefill cache.

The reference's parameters come from one `jax.random` key (its
`ssm_init`), carried over by `bridge.tree_to_torch`; inputs are made
with numpy from a seed. Everything runs at f32, so the tolerance is the
reference's f32 kernel tolerance (rtol / atol 2e-5,
`tests/test_kernels.py:40`): the chunked mixer at ``ssm_chunk`` 8 over
several chunks and over a length that is not a multiple of it (the
single-chunk fallback), decode steps from a prefilled cache, and the
prefill's conv caches and final state (a prompt shorter than the conv
window keeps zero conv caches). The port's chunked scan is also held
against the naive per-step recurrence (the definition, in f64) at the
reference's own oracle tolerance (2e-4, `tests/test_ssm.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm

F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name="mamba2-130m", **kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(name), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(name), **kw))


def _params(jcfg, seed=0):
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jp, tp


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_init_matches_reference_layout(name):
    """`ssm_init` gives the reference's tree, shapes and dtypes, with its
    fixed leaves (a_log, dt_bias, ssm_d, conv biases) equal."""
    jcfg, tcfg = _cfgs(name)
    _, tp = _params(jcfg)
    own = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg)

    def layout(node):
        if isinstance(node, dict):
            return {k: layout(v) for k, v in node.items()}
        return (tuple(node.shape), node.dtype)

    assert layout(own) == layout(tp)
    torch.testing.assert_close(own["a_log"], tp["a_log"], rtol=1e-6,
                               atol=1e-6)
    for key in ("dt_bias", "ssm_d"):
        assert torch.equal(own[key], tp[key])


@pytest.mark.parametrize("s", [32, 20], ids=["multi_chunk", "fallback"])
@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_mixer_matches_reference(name, s):
    """`ssm_mixer` at ``ssm_chunk`` 8: S 32 runs four chunks and the
    inter-chunk recurrence, S 20 the single-chunk fallback."""
    jcfg, tcfg = _cfgs(name, ssm_chunk=8)
    jp, tp = _params(jcfg, seed=1)
    x = _x(2, (2, s, jcfg.d_model))
    want = np.asarray(jssm.ssm_mixer(jp, x, jcfg))
    got = tssm.ssm_mixer(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _naive_ssd(x, bh, ch, dt, a_log):
    """The recurrence h <- h·exp(dt·A) + dt·B⊗x, y = h·C, step by step in
    f64 (no D skip)."""
    b, s, nh, hd = x.shape
    h = np.zeros((b, nh, hd, bh.shape[-1]))
    y = np.zeros((b, s, nh, hd))
    a = -np.exp(a_log.astype(np.float64))
    for t in range(s):
        h = (h * np.exp(dt[:, t] * a)[:, :, None, None]
             + np.einsum("bh,bhs,bhd->bhds", dt[:, t], bh[:, t], x[:, t]))
        y[:, t] = np.einsum("bhds,bhs->bhd", h, ch[:, t])
    return y


@pytest.mark.parametrize("s", [32, 20], ids=["multi_chunk", "fallback"])
def test_ssd_chunked_matches_naive_recurrence(s):
    """The port's chunked scan equals the per-step recurrence (the
    reference's oracle, at its tolerance) over chunks of 8 and in the
    single-chunk fallback."""
    rng = np.random.default_rng(3)
    b, nh, hd, ds = 2, 4, 16, 8
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    bh = (rng.standard_normal((b, s, nh, ds)) * 0.5).astype(np.float32)
    ch = (rng.standard_normal((b, s, nh, ds)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, nh)).astype(np.float32)
    got = tssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, bh, ch, dt,
                                                           a_log)), 8)
    want = _naive_ssd(*(t.astype(np.float64) for t in (x, bh, ch, dt)),
                      a_log)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_decode_steps_match_reference(name):
    """Four decode steps from a cache of random state and conv windows:
    outputs and every cache leaf at f32 tolerance, the port's cache
    updated in place."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    jc = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jssm.init_ssm_cache(jcfg, 3))
    tc = {k: torch.from_numpy(v.copy()) for k, v in jc.items()}
    leaves = {k: v for k, v in tc.items()}
    for step in range(4):
        x = _x(10 + step, (3, jcfg.d_model))
        jy, jc = jssm.ssm_decode(jp, jc, x, jcfg)
        ty, tc = tssm.ssm_decode(tp, tc, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
        for k in jc:
            assert tc[k] is leaves[k]
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **F32)


@pytest.mark.parametrize("s", [40, 2], ids=["prompt", "shorter_than_conv"])
@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_prefill_ssm_cache_matches_reference(name, s):
    """`block_apply(mode="prefill")` fills the conv caches with the last
    dc - 1 pre-conv inputs and the state with the recurrence's final one,
    as the reference's `_prefill_ssm_cache`; a prompt of 2 tokens (fewer
    than dc - 1 = 3) keeps zero conv caches."""
    jcfg, tcfg = _cfgs(name, activation_dtype="float32")
    kind = [k for k in jcfg.layer_kinds() if k.mixer in ("mamba", "hymba")
            and k.window == 0][0]
    jp = jblocks.block_init(jax.random.PRNGKey(6), jcfg, kind)
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    h = _x(7, (2, s, jcfg.d_model))
    jc = jblocks._prefill_ssm_cache(
        jp, h, jcfg, kind, {"ssm": jssm.init_ssm_cache(jcfg, 2)})["ssm"]
    tc = tssm.init_ssm_cache(tcfg, 2, device="cpu")
    tssm.fill_ssm_cache_from_prefill(tc, tp["ssm"], torch.from_numpy(h),
                                     tcfg)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **F32)
    if s < jcfg.ssm_conv - 1:
        assert not any(tc[k].any() for k in ("conv_x", "conv_b", "conv_c"))
    # the block's prefill writes the same leaves into its cache entry
    x = _x(8, (2, s, jcfg.d_model))
    cache = tblocks.init_block_cache(tcfg, kind, 2, 64, torch.float32,
                                     device="cpu")
    positions = torch.arange(s, dtype=torch.int32)[None].expand(2, s)
    _, cache, _ = tblocks.block_apply(tp, torch.from_numpy(x), tcfg, kind,
                                      mode="prefill", positions=positions,
                                      cache=cache)
    _, jcache, _ = jblocks.block_apply(
        jp, jnp.asarray(x), jcfg, kind, mode="prefill",
        positions=jnp.asarray(positions.numpy()),
        cache=jblocks.init_block_cache(jcfg, kind, 2, 64, jnp.float32))
    for k in jcache["ssm"]:
        np.testing.assert_allclose(cache["ssm"][k].numpy(),
                                   np.asarray(jcache["ssm"][k]), **F32)
