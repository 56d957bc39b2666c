"""Port parity: the reference's SSM and hybrid families on their smoke
configs — mamba2-130m (attention-free Mamba-2 SSD, no MLP) and
hymba-1.5b (attention ∥ SSD in every layer, sliding-window layers
between global ones, a GLU MLP).

The reference's params (`Model.init` with a `jax.random` key) are carried
over by `bridge.params_to_torch`; inputs are made with numpy from a seed.
With f32 activations and caches on both sides the tolerance is the
reference's f32 kernel tolerance (rtol / atol 2e-5,
`tests/test_kernels.py:40`): forward logits and the loss, a prefill and
decode steps over the dense cache (hymba's windowed layers' rings wrap),
and a decode step of the one-shot engine's layout (page pools for
hymba's global layers, per-slot rings and SSM states) after
`commit_prefill`, whose ring and SSM entries equal the reference's,
a reused slot included. Quantization runs both pipelines on the
reference's calibration stats: the same linears (mamba2's ``wdt`` of
768 -> 24 quantized at full width, hymba's 1600 -> 50 kept float), the
same words, zeros and AWQ_MACRO bytes. Within the port, the one-shot
engine's greedy streams equal its own `generate()`; the chunked path,
speculation, preemption, disaggregation and training raise.
`roofline.costmodel.cell_costs` equals the reference's.
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
from repro.serving import kv_pager as jkv
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import awq as tawq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear, packed_linear_macro_bytes
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.core.quantize import QuantConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import Model
from repro_torch.roofline import costmodel as tcost
from repro_torch.serving import kv_pager as tkv
from repro_torch.serving.disagg import DisaggController
from repro_torch.serving.engine import GenerationEngine

ARCHS = ["mamba2-130m", "hymba-1.5b"]
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
    """`config()` and `smoke_config()` equal the reference's field for
    field, with the same layer kinds: mamba2 all ``mamba`` without an
    MLP; hymba ``hymba`` layers, global at 0, 15 and 31 (0, 2 and 4 in
    the smoke config) and windowed between them."""
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(name), getattr(tconfigs, get)(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert ([dataclasses.asdict(k) for k in t.layer_kinds()]
                == [dataclasses.asdict(k) for k in j.layer_kinds()])
        assert t.n_params() == j.n_params()
    kinds = tconfigs.get_config(name).layer_kinds()
    if name == "mamba2-130m":
        assert {(k.mixer, k.mlp) for k in kinds} == {("mamba", "none")}
    else:
        assert [i for i, k in enumerate(kinds) if not k.window] == [0, 15, 31]
        assert {k.mixer for k in kinds} == {"hymba"}


def test_bridged_params_have_the_port_layout(arch):
    """The bridged reference params have the tree, shapes and dtypes of
    the port's own `Model.init`."""
    _, _, _, tm, tp = arch
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def layout(node):
        if isinstance(node, dict):
            return {k: layout(v) for k, v in node.items()}
        if isinstance(node, list):
            return [layout(v) for v in node]
        return (tuple(node.shape), node.dtype)

    assert layout(tp) == layout(own)


def test_forward_and_loss_match_reference(arch):
    """`forward_logits` over [2, 40] tokens (hymba's smoke window is 32;
    S 40 is not a multiple of the smoke ``ssm_chunk`` 32, so the SSD runs
    its single-chunk fallback) and `loss`, at f32 tolerance."""
    _, jm, jp, tm, tp = arch
    toks = _toks(1, (2, 40))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    tl = tm.forward_logits(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jloss, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)


@pytest.mark.parametrize("s", [64, 30], ids=["two_chunks", "short"])
def test_prefill_and_decode_logits_match_reference(arch, s):
    """A prefill of 2 × S tokens (S 64: two SSD chunks of 32 and past
    hymba's window of 32; S 30: inside it), then 6 greedy decode steps
    over an f32 dense cache (hymba's rings wrap), logits at f32
    tolerance."""
    _, jm, jp, tm, tp = arch
    toks = _toks(2, (2, s))
    jc = jm.init_cache(2, 80, dtype=jnp.float32)
    tc = tm.init_cache(2, 80, dtype=torch.float32, device="cpu")
    jc, jl, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc, tl, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    decode = jax.jit(jm.decode_step)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(nxt), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


def _assert_cache_equal(tcache, jcache):
    """Every leaf of the port's per-layer cache equals the reference's
    stacked one (pool page 0, the scratch page, excluded)."""
    jn = _np(jcache)
    for seg, layers in tcache.items():
        for i, entry in enumerate(layers):
            for key, leaves in entry.items():
                for leaf, got in leaves.items():
                    want = jn[seg][key][leaf][i]
                    if key == "kv_pool":
                        got, want = got[1:], want[1:]
                    np.testing.assert_array_equal(
                        got.float().numpy(), np.asarray(want, np.float32),
                        err_msg=f"{seg}/{i}/{key}/{leaf}")


def test_commit_prefill_matches_reference(arch):
    """`commit_prefill` of the reference's prefill caches into slot 1 of a
    one-shot engine's layout (3 slots, pages of 8, slot_seq 64, int8
    pools): a 40-token prompt (past hymba's ring of 32), then the slot
    reused by a 2-token prompt (shorter than the conv window: zero conv
    caches). Every ring, SSM and pool leaf equals the reference's after
    each commit; the reused slot keeps nothing of its first occupant
    (its ring row is zero past the new prompt)."""
    name, jm, jp, tm, tp = arch
    jcache = jm.init_paged_cache(3, 17, 8, 64, dtype=jnp.float32,
                                 kv_quant="int8")
    rng = np.random.default_rng(3)
    jcache = jax.tree_util.tree_map(     # stale state in every slot
        lambda a: jnp.asarray(rng.uniform(-1, 1, a.shape) * 5, a.dtype),
        jcache)
    tcache = bridge.paged_cache_to_torch(_np(jcache), device="cpu")
    for s, pages in ((40, [4, 9, 2, 11, 7]), (2, [5])):
        toks = _toks(4 + s, (1, s))
        pre, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                               jm.init_cache(1, s, dtype=jnp.float32))
        jcache = jkv.commit_prefill(jcache, pre, jnp.int32(1),
                                    jnp.asarray(pages, jnp.int32),
                                    page_size=8)
        tout = tkv.commit_prefill(tcache, bridge.paged_cache_to_torch(
            _np(pre), device="cpu"), 1, pages, page_size=8)
        assert tout is tcache
        _assert_cache_equal(tcache, jcache)
    rings = [e["kv"] for layers in tcache.values() for e in layers
             if "kv" in e]
    assert bool(rings) == (name == "hymba-1.5b")
    for ring in rings:
        assert not ring["k"][1, 2:].any() and not ring["v"][1, 2:].any()
    for layers in tcache.values():
        for e in layers:
            assert not any(e["ssm"][k][1].any()
                           for k in ("conv_x", "conv_b", "conv_c"))


def test_oneshot_decode_matches_reference(arch):
    """The one-shot engine's step over that layout: two prompts prefilled
    and committed by each side (the port from its own prefill), then 3
    paged decode steps over 3 slots (slot 2 idle), logits of the live
    rows at f32 tolerance (bf16 pools, read by the gather path on the
    CPU)."""
    _, jm, jp, tm, tp = arch
    jcache = jm.init_paged_cache(3, 17, 8, 64, dtype=jnp.float32,
                                 kv_quant="none")
    tcache = tm.init_paged_cache(17, 8, torch.float32, kv_quant="none",
                                 device="cpu", num_slots=3, slot_seq=64)
    table = np.zeros((3, 8), np.int32)
    table[0, :6], table[1, :3] = [3, 5, 7, 9, 11, 13], [2, 4, 6]
    lens = (37, 12)
    jfirst, tfirst = [], []
    for slot, s in enumerate(lens):
        toks = _toks(10 + s, (1, s))
        pages = table[slot, :-(-s // 8)].tolist()
        pre, jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                jm.init_cache(1, s, dtype=jnp.float32))
        jcache = jkv.commit_prefill(jcache, pre, jnp.int32(slot),
                                    jnp.asarray(pages, jnp.int32),
                                    page_size=8)
        tpre, tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tm.init_cache(1, s, dtype=torch.float32,
                                               device="cpu"))
        tkv.commit_prefill(tcache, tpre, slot, pages, page_size=8)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
        jfirst.append(int(jnp.argmax(jl)))
        tfirst.append(int(tl.argmax()))
    assert jfirst == tfirst
    tok = np.array(jfirst + [0], np.int32)
    pos = np.array([*lens, 0], np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jcache = decode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
                            jnp.asarray(table))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **F32)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tok[2] = 0
        pos = pos + np.array([1, 1, 0], np.int32)


def _macro_bytes_ref(p) -> bytes:
    return jpack.awq_macro_bytes(np.asarray(jpack.unpack_int4(p.qweight)),
                                 np.asarray(p.scales), np.asarray(p.zeros),
                                 p.group_size)


def test_awq_quantized_trees_equal_reference(arch):
    """Both pipelines quantize the same float params with the reference's
    calibration stats (AWQ, GS 64): the same linears, all calibrated (the
    capture names the SSM linears ``ssm/wz`` … ``ssm/out_proj`` and
    hymba's attention ``attn/...``), the same bytes; every linear whose
    searched input scale agrees packs equal words and zeros and equal
    AWQ_MACRO bytes (a pick may differ only on a tie of the candidate
    losses: at most one linear a model)."""
    name, jm, jp, _, tp = arch
    cfg = jconfigs.get_smoke_config(name)
    batch = jmake(cfg, 2, 64, seed=123).batch_at(0)
    with jcal.CalibrationCapture() as cap:
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert any("/ssm/out_proj@" in k for k in cap.stats)
    jq, jrep = jpipe.quantize_params(
        jp, cap.stats, jawq.AWQConfig(quant=JQuantConfig(group_size=64)))
    tq, trep = tpipe.quantize_params(
        tp, cap.stats, tawq.AWQConfig(quant=QuantConfig(group_size=64)))
    assert trep.packed_bytes == jrep.packed_bytes
    assert ({p.replace(f"/{p.split('/')[2]}/", "/", 1)
             for p in trep.quantized} == set(jrep.quantized))
    assert set(trep.calibrated) == set(trep.quantized)
    jtree = bridge.params_to_torch(_np(jq), device="cpu")
    disagreed = 0
    for path in trep.quantized:
        _, seg, i, *keys = path.split("/")
        got = tq["segments"][seg][int(i)]
        ref = jtree["segments"][seg][int(i)]
        for k in keys:
            got, ref = got[k], ref[k]
        assert isinstance(got, PackedLinear) and isinstance(ref, PackedLinear)
        if not all(torch.equal(getattr(got, f), getattr(ref, f))
                   for f in ("qweight", "zeros")):
            disagreed += 1
            continue
        np.testing.assert_allclose(got.scales.numpy(), ref.scales.numpy(),
                                   rtol=2e-5)
        jone = jq["segments"][seg]
        for k in keys:
            jone = jone[k]
        jone = jax.tree_util.tree_map(lambda a: a[int(i)], jone)
        assert packed_linear_macro_bytes(got) == _macro_bytes_ref(jone), path
    assert disagreed <= 1


@pytest.mark.parametrize("name,per_layer", [("mamba2-130m", (6, 0)),
                                            ("hymba-1.5b", (12, 1))])
def test_full_width_layer_quantizes_the_reference_linears(name, per_layer):
    """At the published widths (one layer, a vocabulary of 512: neither
    changes what a layer holds) RTN quantizes the reference's
    ``_quantizable`` linears: mamba2's six a layer, ``wdt`` 768 -> 24
    included (144 in 24 layers); hymba's twelve, its ``wdt`` 1600 -> 50
    kept float (50 is not a multiple of 8)."""
    cfg = dataclasses.replace(tconfigs.get_config(name), num_layers=1,
                              vocab_size=512)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, rep = tpipe.quantize_params(params)
    assert (len(rep.quantized), len(rep.skipped)) == per_layer
    assert any(p.endswith("ssm/wdt") for p in
               (rep.quantized if name == "mamba2-130m" else rep.skipped))


@pytest.mark.parametrize("name", ARCHS)
def test_engine_streams_equal_generate(name):
    """RTN int4 smoke model with bf16 activations and caches: 4 greedy
    requests (prompts up to 40 tokens, past hymba's window of 32) through
    the one-shot engine (`_cache_chunkable` picks it: 4 slots, pages of
    8), the slots reused as requests finish, equal the port's own
    `generate()` at B 1. mamba2's cache has no page pool: its pool bytes
    are 0."""
    tm = Model(tconfigs.get_smoke_config(name))
    params, _ = tpipe.quantize_params(
        tm.init(torch.Generator().manual_seed(0), device="cpu"))
    eng = GenerationEngine(tm, params, max_seq=64, num_slots=2, page_size=8)
    prompts = [_toks(20 + i, n) for i, n in enumerate((5, 40, 2, 33))]
    refs = [eng.generate({"tokens": p[None]}, 8)[0] for p in prompts]
    rids = [eng.submit(p, 8) for p in prompts]
    out = eng.drain()
    assert eng._scheduler._run_batch is None          # one-shot
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)
    st = eng.stats()
    assert (st.kv_pool_bytes > 0) == (name == "hymba-1.5b")
    assert st.prefill_tokens == 0
    assert (eng.paged_kv_page_bytes() > 0) == (name == "hymba-1.5b")


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", ARCHS)
def test_cell_costs_equal_reference(name, size):
    """`cell_costs` of prefill and decode cells equals the reference's
    field for field: the SSM linears, state traffic and intra-chunk work,
    hymba's windowed layers at ``min(window, S)`` positions; a train cell
    too."""
    get = {"full": (jconfigs.get_config, tconfigs.get_config),
           "smoke": (jconfigs.get_smoke_config,
                     tconfigs.get_smoke_config)}[size]
    jcfg, tcfg = (g(name) for g in get)
    for quant in (False, True):
        for step, s, b in (("prefill", 200, 1), ("prefill", 1400, 1),
                           ("prefill", 4096, 1), ("decode", 512, 4),
                           ("decode", 4096, 128)):
            a = jcost.cell_costs(jcfg, jcost.serving_cell(step, s, b), quant)
            c = tcost.cell_costs(tcfg, tcost.serving_cell(step, s, b), quant)
            assert dataclasses.asdict(c) == {
                k: getattr(a, k) for k in dataclasses.asdict(c)}
    for quant in (False, True):
        a = jcost.cell_costs(jcfg, jcost.serving_cell("train", 64), quant)
        c = tcost.cell_costs(tcfg, tcost.serving_cell("train", 64), quant)
        assert dataclasses.asdict(c) == {
            k: getattr(a, k) for k in dataclasses.asdict(c)}


@pytest.mark.parametrize("kw", [dict(preemption=True),
                                dict(spec_decode="ngram"),
                                dict(chunked_prefill=True), "disagg"],
                         ids=["preemption", "speculation", "chunked",
                              "disagg"])
@pytest.mark.parametrize("name", ARCHS)
def test_engine_refuses_chunked_only_features(name, kw):
    """Per-slot SSM state (and hymba's rings) is sequential: preemption,
    speculation, the chunked path and a disaggregated request (its
    prefill engine forces that path; ``handoff_min_tokens=0`` sends every
    prompt there) raise at the first submit, as the reference's engine
    raises; a chunk
    step raises; a serving cache without ``num_slots`` / ``slot_seq``
    raises; the train launcher trains both families (3 steps, finite
    losses)."""
    tm = Model(tconfigs.get_smoke_config(name))
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    ekw = dict(max_seq=32, num_slots=2, page_size=8)
    eng = (DisaggController(tm, params, handoff_min_tokens=0, **ekw)
           if kw == "disagg"
           else GenerationEngine(tm, params, **ekw, **kw))
    with pytest.raises(ValueError):
        eng.submit(_toks(0, 5), 2)
    with pytest.raises(ValueError, match="num_slots"):
        tm.init_paged_cache(9, 8, device="cpu")
    cache = tm.init_paged_cache(9, 8, device="cpu", num_slots=2, slot_seq=32)
    assert not GenerationEngine._cache_chunkable(cache)
    with pytest.raises(ValueError, match="one-shot"):
        tm.chunk_step(params, cache, torch.zeros((2, 4), dtype=torch.int32),
                      torch.zeros((2, 4), dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32),
                      page_table=torch.zeros((2, 4), dtype=torch.int32))
    out = tlaunch.main(["--smoke", "--device", "cpu", "--arch", name,
                        "--steps", "3"])
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_serves_awq(name):
    """`launch.serve --smoke --device cpu --arch <name> --quant awq`:
    calibrate, AWQ and pack, then `generate()` (prompts of 40 tokens:
    hymba's rings wrap)."""
    out = tserve.main(["--smoke", "--device", "cpu", "--arch", name,
                       "--quant", "awq", "--batch", "2", "--prompt-len",
                       "40", "--max-new", "8"])
    rep = out["report"]
    assert out["shape"] == [2, 8]
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert rep.quantized and set(rep.calibrated) == set(rep.quantized)
