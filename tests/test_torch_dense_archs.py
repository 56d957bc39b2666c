"""Port parity: the reference's other dense decoders (smollm-360m,
gemma-2b, gemma3-4b, glm4-9b) on their smoke configs.

Each arch's knobs run here: GeGLU (gelu-tanh) fronts, ``rms_plus_one``
norms, embeddings scaled by sqrt(d), qk-norm, partial RoPE
(``rope_fraction`` 0.5), a second RoPE theta on gemma3's windowed layers,
MQA / GQA groups of 1 to 3 and glm4's untied f32 head. The reference's
params (`Model.init` with a `jax.random` key) are carried over by
`bridge.params_to_torch`; inputs are made with numpy from a seed.

Tolerances are the reference's kernel tolerances
(`tests/test_kernels.py:40`): f32 rtol/atol 2e-5, with f32 activations
and f32 caches on both sides (the two frameworks sum the same f32
products in another order: measured ≤ 1.4e-6 of the largest logit over
a prefill and 25 decode steps). Int8 page codes and AWQ-packed words
must be equal. Greedy `generate()` streams keep their K/V in a bf16
cache on both sides, where a last-bit difference can round an element
to the neighbouring bf16 value (up to 2.3e-3 in the logits after 8 steps,
`tests/test_torch_model.py`); the reference decodes the port's stream,
and each of its tokens must be the reference's argmax wherever the
reference's top-2 logit margin is at least 5e-3 (at least 4 positions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import awq as jawq
from repro.core import calibration as jcal
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.core.quantize import QuantConfig as JQuantConfig
from repro.data import make_dataset as jmake
from repro.models import build_model as jbuild
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import awq as tawq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.core.quantize import QuantConfig
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


ARCHS = ["smollm-360m", "gemma-2b", "gemma3-4b", "glm4-9b"]
F32 = dict(rtol=2e-5, atol=2e-5)
CLEAR_MARGIN = 5e-3


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, jax model, jax params, port model, port params), f32
    activations on both sides."""
    name = request.param
    jm = jbuild(dataclasses.replace(jconfigs.get_smoke_config(name),
                                    activation_dtype="float32"))
    tm = Model(dataclasses.replace(tconfigs.get_smoke_config(name),
                                   activation_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    return name, jm, jp, tm, bridge.params_to_torch(_np(jp), device="cpu")


@pytest.fixture(autouse=True)
def f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        yield


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    """`config()` and `smoke_config()` equal the reference's field for
    field, with the same layer kinds, and the registry serves both."""
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(name), getattr(tconfigs, get)(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert ([dataclasses.asdict(k) for k in t.layer_kinds()]
                == [dataclasses.asdict(k) for k in j.layer_kinds()])
        assert t.n_params() == j.n_params()


def test_bridged_params_have_the_port_layout(arch):
    """The bridged reference params have the tree, shapes and dtypes of
    the port's own `Model.init` (so `Model.init`'s draws follow the same
    layout as `params_to_torch`'s output)."""
    _, _, _, tm, tp = arch
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def layout(node):
        if isinstance(node, dict):
            return {k: layout(v) for k, v in node.items()}
        if isinstance(node, list):
            return [layout(v) for v in node]
        return (tuple(node.shape), node.dtype)

    assert layout(tp) == layout(own)
    assert ("lm_head" in tp) == (not tm.cfg.tie_embeddings)


def test_prefill_and_decode_logits_match_reference(arch):
    """A prefill of 2 × 20 tokens, then 4 greedy decode steps over an f32
    dense cache (gemma3's smoke window is 32: the ring's wrap is held in
    `tests/test_torch_ring_cache.py`)."""
    _, jm, jp, tm, tp = arch
    toks = _toks(1, (2, 20))
    jc = jm.init_cache(2, 32, dtype=jnp.float32)
    tc = tm.init_cache(2, 32, dtype=torch.float32, device="cpu")
    jc, jl, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    decode = jax.jit(jm.decode_step)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(nxt), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


def test_chunk_step_logits_and_int8_pools_match_reference(arch):
    """Two unified chunk steps over int8 page pools (3 slots, pages of 8):
    a prefill chunk beside a short prompt and an empty row, then the next
    chunk beside a decode token. Logits at f32 tolerance, int8 codes
    equal, scale strips at rtol 2e-5 (page 0, the padding scratch page,
    is not compared)."""
    _, jm, jp, tm, tp = arch
    table = np.array([[3, 5, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    jcache = jm.init_paged_cache(3, 9, 8, 32, kv_quant="int8")
    tcache = bridge.paged_cache_to_torch(_np(jcache), device="cpu")
    toks = _toks(3, (2, 3, 8))
    pos1 = np.full((3, 8), -1, np.int32)
    pos1[0], pos1[1, :5] = np.arange(8), np.arange(5)
    pos2 = np.full((3, 8), -1, np.int32)
    pos2[0], pos2[1, 0] = np.arange(8, 16), 5
    step = jax.jit(jm.chunk_step)
    for tk, pos, sidx in ((toks[0], pos1, np.array([7, 4, 0], np.int32)),
                          (toks[1], pos2, np.array([7, 0, 0], np.int32))):
        jl, jcache = step(jp, jcache, jnp.asarray(tk), jnp.asarray(pos),
                          jnp.asarray(sidx), jnp.asarray(table))
        tl, tcache = tm.chunk_step(tp, tcache, torch.from_numpy(tk),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(sidx),
                                   page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   **F32)
    jseg = _np(jcache)
    for seg, layers in tcache.items():
        for i, layer in enumerate(layers):
            pool, ref = layer["kv_pool"], jseg[seg]["kv_pool"]
            for key in ("k", "v"):
                np.testing.assert_array_equal(pool[key][1:].numpy(),
                                              ref[key][i, 1:])
            for key in ("ks", "vs"):
                np.testing.assert_allclose(pool[key][1:].numpy(),
                                           ref[key][i, 1:], rtol=2e-5)


def test_awq_packed_words_match_reference(arch):
    """Both packages quantize the same float params with the reference's
    calibration stats (AWQ search, GS 64): the same linears are
    quantized, and each linear whose searched input scale agrees (rtol
    2e-5) packs bit-identical words and zeros. A pick may differ only on
    a tie of the 20 candidate losses (see tests/test_torch_awq.py): at
    most one linear per model may take the other pick."""
    name, jm, jp, _, tp = arch
    cfg = jconfigs.get_smoke_config(name)
    batch = jmake(cfg, 2, 64, seed=123).batch_at(0)
    with jcal.CalibrationCapture() as cap:
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jq, jrep = jpipe.quantize_params(
        jp, cap.stats, jawq.AWQConfig(quant=JQuantConfig(group_size=64)))
    tq, trep = tpipe.quantize_params(
        tp, cap.stats, tawq.AWQConfig(quant=QuantConfig(group_size=64)))
    assert trep.packed_bytes == jrep.packed_bytes
    assert trep.compression_ratio == jrep.compression_ratio
    assert len(trep.calibrated) == len(trep.quantized) > 0
    jtree = bridge.params_to_torch(_np(jq), device="cpu")
    agreed = 0
    for path in trep.quantized:
        _, seg, i, grp, lin = path.split("/")
        got = tq["segments"][seg][int(i)][grp][lin]
        ref = jtree["segments"][seg][int(i)][grp][lin]
        assert isinstance(got, PackedLinear) and isinstance(ref, PackedLinear)
        if not np.allclose(got.input_scale.numpy(), ref.input_scale.numpy(),
                           rtol=2e-5, atol=0):
            continue
        agreed += 1
        for f in ("qweight", "zeros"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (path, f)
        np.testing.assert_allclose(got.scales.numpy(), ref.scales.numpy(),
                                   rtol=2e-5)
    assert agreed >= len(trep.quantized) - 1


def test_greedy_generate_matches_reference(arch):
    """The port's `GenerationEngine.generate` (greedy, bf16 dense cache)
    against the reference's prefill + decode over the same cache type:
    each token the reference's argmax where its margin is clear."""
    _, jm, jp, tm, tp = arch
    prompt = _toks(5, (1, 12))
    n = 10
    eng = GenerationEngine(tm, tp, max_seq=32)
    got = eng.generate({"tokens": prompt}, n)[0]
    jc = jm.init_cache(1, 32, dtype=jnp.bfloat16)
    jc, jl, jpos = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jc)
    decode = jax.jit(jm.decode_step)
    compared = 0
    for i in range(n):                  # the reference fed the port's stream
        lg = np.asarray(jl)[0]
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] >= CLEAR_MARGIN:
            assert got[i] == int(lg.argmax()), f"token {i}"
            compared += 1
        jl, jc = decode(jp, jc, jnp.asarray(got[i:i + 1]), jpos)
        jpos = jpos + 1
    assert compared >= 4
