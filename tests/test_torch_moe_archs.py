"""Port parity: the reference's MoE family on its smoke configs —
qwen2-moe-a2.7b (attention + MoE: 8 experts top-2, 2 shared experts with
the sigmoid gate, QKV bias) and deepseek-v2-lite-16b (MLA + MoE, a dense
first layer, top-2 with ``norm_topk_prob``).

The reference's params (`Model.init` with a `jax.random` key) are carried
over by `bridge.params_to_torch` (stacked experts keep their expert dim
beside the unstacked layer dim); inputs are made with numpy from a seed.
With f32 activations and caches on both sides the tolerance is the
reference's f32 kernel tolerance (rtol / atol 2e-5,
`tests/test_kernels.py:40`): forward logits, the loss with its router
aux term, a prefill and decode steps over the dense cache, and for
qwen2-moe a chunk step over int8 page pools (codes equal). Quantization
runs both pipelines on the reference's calibration stats: the same
linears are quantized (routed experts at RTN, as no forward records
them), and their words, zeros and AWQ_MACRO bytes are equal (an AWQ pick
may differ only on a tie of the candidate losses, as
`tests/test_torch_dense_archs.py` states: at most one calibrated linear
a model). The engine serves qwen2-moe on the chunked path and deepseek on
the one-shot path (`_cache_chunkable` chooses), greedy streams equal to
the port's own `generate()`. `roofline.costmodel`'s MoE and MLA terms
equal the reference's (its split report under the reference's TPU
constants, monkeypatched in).
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
from repro.core import packing as jpack
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.core.quantize import QuantConfig as JQuantConfig
from repro.data import make_dataset as jmake
from repro.models import build_model as jbuild
from repro.roofline import costmodel as jcost
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import awq as tawq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear, packed_linear_macro_bytes
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.core.quantize import QuantConfig
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import Model
from repro_torch.roofline import costmodel as tcost
from repro_torch.serving.engine import GenerationEngine

ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]
F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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
    jql.set_execution_config(compute_dtype=jnp.bfloat16)


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    """`config()` and `smoke_config()` equal the reference's field for field,
    with the same layer kinds (deepseek: a dense first layer, then MoE:
    segments of glu then moe)."""
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(name), getattr(tconfigs, get)(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert ([dataclasses.asdict(k) for k in t.layer_kinds()]
                == [dataclasses.asdict(k) for k in j.layer_kinds()])
        assert t.n_params() == j.n_params()
    mlps = [k.mlp for k, _ in tconfigs.get_config(name).segments()]
    assert mlps == (["glu", "moe"] if name.startswith("deepseek")
                    else ["moe"])


def test_bridged_params_have_the_port_layout(arch):
    """The bridged reference params have the tree, shapes and dtypes of the
    port's own `Model.init` (routed experts [E, K, N] per layer)."""
    _, _, _, tm, tp = arch
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def layout(node):
        if isinstance(node, dict):
            return {k: layout(v) for k, v in node.items()}
        if isinstance(node, list):
            return [layout(v) for v in node]
        return (tuple(node.shape), node.dtype)

    assert layout(tp) == layout(own)
    e = tm.cfg.num_experts
    assert tp["segments"]["seg_0" if e and tm.cfg.first_dense_layers == 0
                          else "seg_1"][0]["moe"]["experts"]["gate"]["w"] \
        .shape == (e, tm.cfg.d_model, tm.cfg.moe_d_ff)


def test_forward_and_loss_match_reference(arch):
    """`forward_logits` over [2, 24] tokens and `loss` (cross-entropy plus
    the layers' router aux losses) at f32 tolerance."""
    _, jm, jp, tm, tp = arch
    toks = _toks(1, (2, 24))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    tl = tm.forward_logits(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jloss, jparts = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tparts = tm.loss(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert float(tparts["aux"]) > 0
    for got, want in ((tloss, jloss), (tparts["aux"], jparts["aux"]),
                      (tparts["ce"], jparts["ce"])):
        np.testing.assert_allclose(float(got), float(want), **F32)


def test_prefill_and_decode_logits_match_reference(arch):
    """A prefill of 2 × 20 tokens, then 4 greedy decode steps over an f32
    dense cache (K/V, or MLA's latents)."""
    _, jm, jp, tm, tp = arch
    toks = _toks(2, (2, 20))
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


def test_chunk_step_matches_reference_or_refuses(arch):
    """qwen2-moe: two chunk steps over int8 page pools (a prefill chunk
    beside a short prompt, then a decode token), logits at f32 tolerance
    and int8 codes equal. deepseek: its latents are per-slot state, so a
    chunk step raises, as the reference's does."""
    name, jm, jp, tm, tp = arch
    table = np.array([[3, 5, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    tcache = tm.init_paged_cache(9, 8, kv_quant="int8", device="cpu",
                                 num_slots=3, slot_seq=32)
    toks = _toks(3, (2, 3, 8))
    pos1 = np.full((3, 8), -1, np.int32)
    pos1[0], pos1[1, :5] = np.arange(8), np.arange(5)
    pos2 = np.full((3, 8), -1, np.int32)
    pos2[0], pos2[1, 0] = np.arange(8, 16), 5
    steps = ((toks[0], pos1, np.array([7, 4, 0], np.int32)),
             (toks[1], pos2, np.array([7, 0, 0], np.int32)))
    if name.startswith("deepseek"):
        assert not GenerationEngine._cache_chunkable(tcache)
        with pytest.raises(ValueError, match="one-shot"):
            tm.chunk_step(tp, tcache, *(torch.from_numpy(a)
                                        for a in steps[0]),
                          page_table=torch.from_numpy(table))
        return
    assert GenerationEngine._cache_chunkable(tcache)
    jcache = jm.init_paged_cache(3, 9, 8, 32, kv_quant="int8")
    step = jax.jit(jm.chunk_step)
    for tk, pos, sidx in steps:
        jl, jcache = step(jp, jcache, jnp.asarray(tk), jnp.asarray(pos),
                          jnp.asarray(sidx), jnp.asarray(table))
        tl, tcache = tm.chunk_step(tp, tcache, torch.from_numpy(tk),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(sidx),
                                   page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **F32)
    jseg = _np(jcache)
    for seg, layers in tcache.items():
        for i, layer in enumerate(layers):
            for key in ("k", "v"):
                np.testing.assert_array_equal(
                    layer["kv_pool"][key][1:].numpy(),
                    jseg[seg]["kv_pool"][key][i, 1:])


def _macro_bytes_ref(p) -> bytes:
    """The reference's AWQ_MACRO bytes of a (possibly stacked) packed
    linear, one slice after another."""
    n = p.qweight.shape[-1]
    qw = np.asarray(p.qweight).reshape(-1, p.qweight.shape[-2], n)
    sc = np.asarray(p.scales).reshape(qw.shape[0], -1, n)
    zr = np.asarray(p.zeros).reshape(qw.shape[0], -1, n)
    return b"".join(jpack.awq_macro_bytes(
        np.asarray(jpack.unpack_int4(jnp.asarray(q))), s, z, p.group_size)
        for q, s, z in zip(qw, sc, zr))


def test_awq_quantized_trees_equal_reference(arch):
    """Both pipelines quantize the same float params with the reference's
    calibration stats (AWQ, GS 64): the same linears, the same bytes; the
    routed experts (stacked, RTN) and every linear whose searched input
    scale agrees pack equal words and zeros, and equal AWQ_MACRO bytes."""
    name, jm, jp, _, tp = arch
    cfg = jconfigs.get_smoke_config(name)
    batch = jmake(cfg, 2, 64, seed=123).batch_at(0)
    with jcal.CalibrationCapture() as cap:
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert not any("experts" in k for k in cap.stats)
    jq, jrep = jpipe.quantize_params(
        jp, cap.stats, jawq.AWQConfig(quant=JQuantConfig(group_size=64)))
    tq, trep = tpipe.quantize_params(
        tp, cap.stats, tawq.AWQConfig(quant=QuantConfig(group_size=64)))
    assert trep.packed_bytes == jrep.packed_bytes
    assert trep.compression_ratio == jrep.compression_ratio
    # the reference lists a stacked leaf once, the port once a layer
    assert ({p.replace(f"/{p.split('/')[2]}/", "/", 1)
             for p in trep.quantized} == set(jrep.quantized))
    routed = [p for p in trep.quantized if "/experts/" in p]
    assert routed and not set(routed) & set(trep.calibrated)
    jtree = bridge.params_to_torch(_np(jq), device="cpu")
    jnp_tree = _np(jq)
    disagreed = 0
    for path in trep.quantized:
        _, seg, i, *keys = path.split("/")
        got = tq["segments"][seg][int(i)]
        ref = jtree["segments"][seg][int(i)]
        jref = jnp_tree["segments"][seg]
        for k in keys:
            got, ref, jref = got[k], ref[k], jref[k]
        assert isinstance(got, PackedLinear) and isinstance(ref, PackedLinear)
        if not torch.equal(got.input_scale, ref.input_scale):
            np.testing.assert_allclose(got.input_scale.numpy(),
                                       ref.input_scale.numpy(), rtol=2e-5)
        if not all(torch.equal(getattr(got, f), getattr(ref, f))
                   for f in ("qweight", "zeros")):
            assert path not in routed, path
            disagreed += 1
            continue
        np.testing.assert_allclose(got.scales.numpy(), ref.scales.numpy(),
                                   rtol=2e-5)
        one = jax.tree_util.tree_map(lambda a: a[int(i)], jref)
        assert packed_linear_macro_bytes(got) == _macro_bytes_ref(one), path
    assert disagreed <= 1


@pytest.mark.parametrize("name", ARCHS)
def test_engine_streams_equal_generate(name):
    """RTN int4 smoke model with bf16 activations and caches: 4 greedy
    requests through the engine (4 slots, pages of 8) equal the port's own
    `generate()` at B 1. qwen2-moe takes the chunked path, deepseek the
    one-shot path, by `_cache_chunkable` alone."""
    tm = Model(tconfigs.get_smoke_config(name))
    params, _ = tpipe.quantize_params(
        tm.init(torch.Generator().manual_seed(0), device="cpu"))
    eng = GenerationEngine(tm, params, max_seq=64, num_slots=4, page_size=8,
                           prefill_chunk=8)
    prompts = [_toks(20 + i, n) for i, n in enumerate((5, 17, 12, 30))]
    refs = [eng.generate({"tokens": p[None]}, 8)[0] for p in prompts]
    rids = [eng.submit(p, 8) for p in prompts]
    out = eng.drain()
    chunked = eng._scheduler._run_batch is not None
    assert chunked == name.startswith("qwen2-moe")
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)
    st = eng.stats()
    assert (st.kv_pool_bytes > 0) == chunked
    assert (st.prefill_tokens > 0) == chunked


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", ARCHS)
def test_cell_costs_equal_reference(name, size):
    """`cell_costs` of prefill and decode cells equals the reference's
    field for field: the routed experts' weights streamed once a step and
    computed on the top-k share of the tokens, the shared experts and
    router on every token, MLA's latent cache line; a train cell too."""
    get = {"full": (jconfigs.get_config, tconfigs.get_config),
           "smoke": (jconfigs.get_smoke_config,
                     tconfigs.get_smoke_config)}[size]
    jcfg, tcfg = (g(name) for g in get)
    for quant in (False, True):
        for step, s, b in (("prefill", 200, 1), ("prefill", 4096, 1),
                           ("decode", 512, 4), ("decode", 4096, 128)):
            a = jcost.cell_costs(jcfg, jcost.serving_cell(step, s, b), quant)
            c = tcost.cell_costs(tcfg, tcost.serving_cell(step, s, b), quant)
            assert dataclasses.asdict(c) == {
                k: getattr(a, k) for k in dataclasses.asdict(c)}
    for quant in (False, True):
        a = jcost.cell_costs(jcfg, jcost.serving_cell("train", 64), quant)
        c = tcost.cell_costs(tcfg, tcost.serving_cell("train", 64), quant)
        assert dataclasses.asdict(c) == {
            k: getattr(a, k) for k in dataclasses.asdict(c)}


@pytest.mark.parametrize("name", ARCHS)
def test_disagg_report_equals_reference_under_its_constants(monkeypatch,
                                                            name):
    """The split report from the MoE and MLA terms equals the reference's
    under the reference's TPU constants (monkeypatched in)."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", 197e12)
    monkeypatch.setattr(tcost, "HBM_BW", 819e9)
    for kw in (dict(decode_batch=128, context=4096),
               dict(decode_batch=4, context=512, quant=True)):
        assert (tcost.disagg_report(tconfigs.get_config(name), **kw)
                == jcost.disagg_report(jconfigs.get_config(name), **kw))


@pytest.mark.parametrize("kw", [dict(preemption=True),
                                dict(spec_decode="ngram"),
                                dict(chunked_prefill=True)],
                         ids=["preemption", "speculation", "chunked"])
def test_mla_engine_refuses_chunked_only_features(kw):
    """deepseek's latents are per-slot state: preemption, speculation and
    the chunked path (so disaggregation, which forces it) raise at the
    first submit, as the reference's engine raises; and the train
    launcher trains the model (3 steps, finite losses)."""
    tm = Model(tconfigs.get_smoke_config("deepseek-v2-lite-16b"))
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    eng = GenerationEngine(tm, params, max_seq=32, num_slots=2, page_size=8,
                           **kw)
    with pytest.raises(ValueError):
        eng.submit(_toks(0, 5), 2)
    out = tlaunch.main(["--smoke", "--device", "cpu", "--arch",
                        "deepseek-v2-lite-16b", "--steps", "3"])
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
