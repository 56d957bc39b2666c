"""Head dim 32 (glm4-9b's smoke config: 4 q heads over 2 kv heads of 32)
in the port's plain versions of K4, K2 and K4b, and the config's greedy
`generate()` and train step, against the reference.

On the card the hand-written kernels at hd 32 are held against these
plain versions (`tests/test_torch_cuda.py`, ``-k hd32``; `chip_smoke.py`'s
`kernel_shapes` and `glm4_smoke`). Here, the CPU:

  * K4's plain version against the reference's Pallas kernel in interpret
    mode and its oracle (`ref.flash_attention_ref`): f32 rtol/atol 2e-5,
    the reference's f32 kernel tolerance (`tests/test_kernels.py:40`);
  * K2's plain version against the reference's Pallas kernel in interpret
    mode and its oracle, 2e-5, rows that see nothing exactly 0;
  * K4b's plain gradient, through the port's train attention
    (`models.attention.attention`, `FlashAttentionFn` on the CPU), against
    `jax.grad` of the reference's `models/attention.py` attention at the
    same params and input, f32 activations: every gradient within 1e-4
    of its largest magnitude (the bound of `tests/test_torch_train.py`);
  * one train step of the smoke model (f32 activations, f32 casts): loss
    at 2e-5, every gradient leaf within 1e-4 of its largest magnitude;
  * greedy `generate()` at the config's own dtypes (bf16 activations and
    cache): each token the reference's argmax wherever the reference's
    top-2 margin clears 5e-3 (`tests/test_torch_dense_archs.py`'s rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import make_dataset as jmake_dataset
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import build_model
from repro.models.attention import _kv_quantize
from repro.utils.tree import flatten_with_paths as jflatten

from repro_torch import bridge, configs
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import paged_attention as k2
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model
from repro_torch.serving.engine import GenerationEngine
from repro_torch.training.train_step import loss_and_grads


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
HD = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_glm4_smoke_config_has_head_dim_32():
    cfg = configs.get_smoke_config("glm4-9b")
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads) == (32, 4, 2)
    assert cfg.head_dim == jconfigs.get_smoke_config("glm4-9b").head_dim
    assert HD in k4.HEAD_DIMS and HD in k4.BWD_HEAD_DIMS
    assert HD in k2.HEAD_DIMS


@pytest.mark.parametrize("b,h,hkv,s,causal,window", [
    (2, 4, 2, 128, True, 0),            # glm4 smoke: S up to 128, G 2
    (1, 4, 2, 256, True, 64),           # windowed
    (2, 4, 4, 128, False, 0),           # bidirectional, G 1
    (1, 8, 1, 128, True, 0)])           # MQA, G 8
def test_k4_plain_hd32_matches_jax_kernel_and_oracle(b, h, hkv, s, causal,
                                                     window):
    rng = np.random.default_rng(s + h)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, HD), (b, hkv, s, HD), (b, hkv, s, HD)))
    got = k4.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jflash(jq, jk, jv, causal=causal, window=window, block_q=64,
                  block_k=64, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


@pytest.mark.parametrize("s", [1, 37, 129])
def test_k4_plain_hd32_ragged_s_and_lse(s):
    """Ragged S against the oracle; the forward's lse (what K4b reads)
    is the log-sum-exp of each row's visible scaled scores."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, n, s, HD)).astype(np.float32)
               for n in (4, 2, 2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = k4.flash_attention_lse_ref(tq, tk, tv)
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **F32)
    sc = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, 2, axis=1)) * HD ** -0.5
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    want = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) \
        + sc.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, **F32)


@pytest.mark.parametrize("c", [1, 16])
def test_k2_plain_hd32_matches_jax_kernel_and_oracle(c):
    """glm4 smoke's pools: 2 kv heads of 32, G 2, pages of 16, slots of 8
    pages (max_seq 128), a padding row."""
    b, hkv, g, p, nblk, npages = 3, 2, 2, 16, 8, 25
    rng = np.random.default_rng(c)
    shape = (npages, p, hkv, HD)
    k, ks = (np.array(a) for a in _kv_quantize(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32) * 2)))
    v, vs = (np.array(a) for a in _kv_quantize(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32))))
    q = rng.standard_normal((b, c, hkv, g, HD)).astype(np.float32)
    table = rng.permutation(np.arange(1, npages))[:b * nblk].reshape(
        b, nblk).astype(np.int32)
    base = np.array([3, nblk * p - c - 2, 0], np.int32)
    pos = base[:, None] + np.arange(c, dtype=np.int32)[None]
    pos[2] = -1
    args = (q, k, ks, v, vs, table, pos)
    got = k2.paged_attention_chunk(*map(torch.from_numpy, args)).numpy()
    kern = np.asarray(jpa.paged_attention_chunk(*map(jnp.asarray, args),
                                                interpret=True))
    oracle = np.asarray(jref.paged_attention_chunk_ref(
        *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, kern, **F32)
    np.testing.assert_allclose(got, oracle, **F32)
    assert not got[2].any() and not kern[2].any()


def _close(got: np.ndarray, want: np.ndarray, name, bound=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    lim = bound * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= lim, (name, np.abs(got - want).max(),
                                             lim)


@pytest.mark.parametrize("window", [0, 16])
def test_k4b_plain_grad_matches_jax_grad_of_reference_attention(window):
    """The port's train attention at glm4 smoke's widths (d 128, partial
    RoPE, QKV bias) under autograd, K4b's plain version in its backward,
    against `jax.grad` of the reference's attention: the input's and every
    weight's gradient."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("glm4-9b"),
                                activation_dtype="float32")
    cfg_t = dataclasses.replace(configs.get_smoke_config("glm4-9b"),
                                activation_dtype="float32")
    jp = jattn.attn_init(jax.random.PRNGKey(3), cfg_j)
    rng = np.random.default_rng(window)
    b, s = 2, 48
    x = rng.standard_normal((b, s, cfg_j.d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()

    def jloss(p, xx):
        y = jattn.attention(p, xx, cfg_j, positions=jnp.asarray(pos),
                            window=window)
        return jnp.sum(y * jnp.asarray(ct))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                             requires_grad=True), jp)
    tx = torch.tensor(x, requires_grad=True)
    y = tattn.attention(tp, tx, cfg_t, positions=torch.from_numpy(pos),
                        window=window)
    before = k4.BWD_COUNTER.count
    (y * torch.from_numpy(ct)).sum().backward()
    assert k4.BWD_COUNTER.count == before      # the plain version: no launch
    _close(tx.grad.numpy(), np.asarray(jgx), "x")
    for path, g in jflatten(jgp):
        leaf = tp
        for key in path.split("/"):
            leaf = leaf[key]
        _close(leaf.grad.numpy(), np.asarray(g), path)


def test_train_step_matches_reference():
    """One smoke train step's loss and gradients (f32 activations, f32
    casts) against the reference's `jax.value_and_grad` of its loss."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config("glm4-9b"),
                              activation_dtype="float32")
    jm = build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = jmake_dataset(cfg, 2, 64).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(dataclasses.replace(configs.get_smoke_config("glm4-9b"),
                                      activation_dtype="float32"))
    params = bridge.params_to_torch(_np(jparams), device="cpu")
    loss, _, grads = loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        "float32")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    got = bridge.state_to_arrays(grads)
    want = dict(jflatten(jgrads))
    assert set(got) == set(want)
    for path, w in want.items():
        _close(got[path], w, path)


def test_greedy_generate_matches_reference():
    """`generate()` at the config's own dtypes (bf16 activations, bf16
    cache) on both sides: the reference decodes the port's stream, and
    each token is the reference's argmax where its margin is clear."""
    jm = build_model(jconfigs.get_smoke_config("glm4-9b"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Model(configs.get_smoke_config("glm4-9b"))
    tp = bridge.params_to_torch(_np(jp), device="cpu")
    prompt = np.random.default_rng(7).integers(0, 512, (1, 20)).astype(
        np.int32)
    n = 12
    got = GenerationEngine(tm, tp, max_seq=64).generate(
        {"tokens": prompt}, n)[0]
    jc = jm.init_cache(1, 64, dtype=jnp.bfloat16)
    jc, jl, jpos = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jc)
    decode = jax.jit(jm.decode_step)
    compared = 0
    for i in range(n):
        lg = np.asarray(jl, np.float32)[0]
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] >= 5e-3:
            assert got[i] == int(lg.argmax()), f"token {i}"
            compared += 1
        jl, jc = decode(jp, jc, jnp.asarray(got[i:i + 1]), jpos)
        jpos = jpos + 1
    assert compared >= 6
