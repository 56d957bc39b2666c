"""Port parity: the reference's VLM, phi-3-vision-4.2b, on its smoke config
— stub patch embeddings ``[B, num_patches, frontend_dim]`` through
``patch_proj``, prepended to the token embeddings of a phi3-mini decoder
(MHA, SiLU GLU, RMSNorm, RoPE, an untied head), labels masked over the
image span.

The reference's params (`Model.init` with a `jax.random` key) are carried
over by `bridge.params_to_torch`; batches come from both data pipelines
(equal element for element) or from numpy with a seed. With f32
activations on both sides the tolerance is the reference's f32 kernel
tolerance (rtol / atol 2e-5, `tests/test_kernels.py:40`):
`forward_logits` and `loss` with images, a prefill with images and three
decode steps at positions from ``num_patches + S`` on, and `generate()`
with images (greedy tokens equal wherever the reference's top-2 margin
is clear). Quantization runs both pipelines on the reference's
calibration stats over tokens and images: the same linears (``patch_proj``
and ``lm_head`` float), words, zeros and AWQ_MACRO bytes. `cell_costs`
of prefill and decode cells equals the reference's. Within the port, the
engine serves the text (`submit()` takes tokens only) with streams equal
to its own `generate()`; a `generate()` whose ``max_seq`` does not hold
the image span raises; the train launcher trains the model.
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
from repro.serving import GenerationEngine as JEngine
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import awq as tawq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear, packed_linear_macro_bytes
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.core.quantize import QuantConfig
from repro_torch.data.pipeline import make_dataset
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import Model
from repro_torch.roofline import costmodel as tcost
from repro_torch.serving.engine import GenerationEngine

NAME = "phi-3-vision-4.2b"
F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _f32(cfg):
    return dataclasses.replace(cfg, activation_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params), f32 activations
    on both sides."""
    jm = jbuild(_f32(jconfigs.get_smoke_config(NAME)))
    tm = Model(_f32(tconfigs.get_smoke_config(NAME)))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.params_to_torch(_np(jp), device="cpu")


@pytest.fixture(autouse=True)
def f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with execution_config(ExecutionConfig(compute_dtype=torch.float32)):
        yield
    jql.set_execution_config(compute_dtype=jnp.bfloat16)


def _batch(seed, b, s):
    """Tokens, next-token labels and images from numpy with a seed."""
    cfg = tconfigs.get_smoke_config(NAME)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "images": rng.standard_normal(
                (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(get):
    """Both configs equal the reference's field for field, with its layer
    kinds: causal attention with a GLU MLP, a vision frontend of
    ``num_patches`` patches."""
    j, t = getattr(jconfigs, get)(NAME), getattr(tconfigs, get)(NAME)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ([dataclasses.asdict(k) for k in t.layer_kinds()]
            == [dataclasses.asdict(k) for k in j.layer_kinds()])
    assert t.n_params() == j.n_params()
    assert t.frontend == "vision" and not t.is_encoder
    assert {(k.mixer, k.mlp) for k in t.layer_kinds()} == {("attn", "glu")}


@pytest.mark.parametrize("step", [0, 2])
def test_batches_equal_reference(step):
    """The vision batch (the Markov token stream, then unit-normal patch
    embeddings from the same Philox stream) equals the reference's
    element for element, at two steps."""
    cfg = tconfigs.get_smoke_config(NAME)
    got = make_dataset(cfg, 3, 24, seed=5).batch_at(step)
    want = jmake(jconfigs.get_smoke_config(NAME), 3, 24, seed=5).batch_at(
        step)
    assert got.keys() == want.keys() == {"tokens", "labels", "images"}
    assert got["images"].shape == (3, cfg.num_patches, cfg.frontend_dim)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_bridged_params_have_the_port_layout(models):
    """The bridged reference params (``frontend/patch_proj`` with its
    bias, an untied ``lm_head``) have the tree, shapes and dtypes of the
    port's own `Model.init`."""
    _, _, tm, tp = models
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def layout(node):
        if isinstance(node, dict):
            return {k: layout(v) for k, v in node.items()}
        if isinstance(node, list):
            return [layout(v) for v in node]
        return (tuple(node.shape), node.dtype)

    assert layout(tp) == layout(own)
    assert set(own["frontend"]["patch_proj"]) == {"w", "b"}


def test_forward_and_loss_with_images_match_reference(models):
    """`forward_logits` over 8 patches + [2, 30] tokens gives logits at
    every position of the whole sequence (38), and `loss` with the labels
    padded over the image span counts only the text's labels; both at
    f32 tolerance. Without images the model is a plain decoder."""
    jm, jp, tm, tp = models
    batch = _batch(1, 2, 30)
    jl = jm.forward_logits(jp, _j(batch))
    tl = tm.forward_logits(tp, _t(batch))
    assert tl.shape == (2, 38, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jloss, jaux = jm.loss(jp, _j(batch))
    tloss, taux = tm.loss(tp, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 60.0
    text = {"tokens": batch["tokens"]}
    np.testing.assert_allclose(tm.forward_logits(tp, _t(text)).numpy(),
                               np.asarray(jm.forward_logits(jp, _j(text))),
                               **F32)


def test_prefill_with_images_and_decode_match_reference(models):
    """A prefill of 8 patches + [2, 20] tokens (next position 28, the
    cache written at positions 0 … 27), then three greedy decode steps at
    positions 28, 29, 30: logits at f32 tolerance."""
    jm, jp, tm, tp = models
    batch = _batch(2, 2, 20)
    del batch["labels"]
    jc = jm.init_cache(2, 48, dtype=jnp.float32)
    tc = tm.init_cache(2, 48, dtype=torch.float32, device="cpu")
    jc, jl, jpos = jm.prefill(jp, _j(batch), jc)
    tc, tl, tpos = tm.prefill(tp, _t(batch), tc)
    np.testing.assert_array_equal(tpos.numpy(), [28, 28])
    np.testing.assert_array_equal(np.asarray(jpos), [28, 28])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(nxt), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tpos)
        jpos, tpos = jpos + 1, tpos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert int(tpos[0]) == 31


def _margins(jm, jp, batch, stream, max_seq):
    """The reference's top-2 margin and logits scale at each position of
    its own greedy ``stream`` (prefill, then decode steps fed it)."""
    cache = jm.init_cache(2, max_seq, dtype=jnp.float32)
    cache, logits, pos = jm.prefill(jp, _j(batch), cache)
    out = []
    for t in range(stream.shape[1]):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        out.append((top2[:, 1] - top2[:, 0],
                    np.abs(np.asarray(logits)).max(-1)))
        logits, cache = jm.decode_step(jp, cache,
                                       jnp.asarray(stream[:, t]), pos)
        pos = pos + 1
    return out


def test_generate_with_images_matches_reference(models):
    """`generate()` with images (8 patches + [2, 16] tokens, 8 new, f32):
    the port's greedy tokens equal the reference engine's up to any
    position whose reference top-2 margin is within 1e-4 of its logits'
    scale (none is expected at these random weights)."""
    jm, jp, tm, tp = models
    batch = _batch(3, 2, 16)
    del batch["labels"]
    ref = JEngine(jm, jp, max_seq=32).generate(_j(batch), 8)
    got = GenerationEngine(tm, tp, max_seq=32).generate(batch, 8)
    assert got.shape == ref.shape == (2, 8)
    margins = _margins(jm, jp, batch, np.asarray(ref), 32)
    for row in range(2):
        for t in range(8):
            if got[row, t] != ref[row, t]:
                margin, scale = margins[t][0][row], margins[t][1][row]
                assert margin <= 1e-4 * scale, (row, t, margin, scale)
                break


def test_generate_raises_when_max_seq_cannot_hold_the_image_span():
    """A vision prompt takes ``num_patches + S`` positions: a `generate()`
    whose cache cannot hold them and the fed-back tokens raises rather
    than cutting the sequence; one that can runs."""
    tm = Model(tconfigs.get_smoke_config(NAME))
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(4, 1, 20)
    eng = GenerationEngine(tm, params, max_seq=32)
    with pytest.raises(ValueError, match="image span"):
        eng.generate(batch, 6)           # 8 + 20 + 5 = 33 > 32
    assert eng.generate(batch, 5).shape == (1, 5)     # 32 positions


def _macro_bytes_ref(p) -> bytes:
    return jpack.awq_macro_bytes(np.asarray(jpack.unpack_int4(p.qweight)),
                                 np.asarray(p.scales), np.asarray(p.zeros),
                                 p.group_size)


def test_awq_quantized_trees_equal_reference():
    """Both pipelines quantize the same float params with the reference's
    calibration stats over tokens and images (AWQ, GS 64): the same
    linears, all calibrated, the same bytes; ``patch_proj`` (excluded by
    name) and ``lm_head`` stay float; every linear whose searched scale
    agrees packs equal words, zeros and AWQ_MACRO bytes (a pick may
    differ only on a tie of the candidate losses: at most one linear)."""
    cfg = jconfigs.get_smoke_config(NAME)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = bridge.params_to_torch(_np(jp), device="cpu")
    batch = jmake(cfg, 2, 64, seed=123).batch_at(0)
    assert "images" in batch
    with jcal.CalibrationCapture() as cap:
        jm.loss(jp, _j(batch))
    assert not any("frontend" in k for k in cap.stats)
    jq, jrep = jpipe.quantize_params(
        jp, cap.stats, jawq.AWQConfig(quant=JQuantConfig(group_size=64)))
    tq, trep = tpipe.quantize_params(
        tp, cap.stats, tawq.AWQConfig(quant=QuantConfig(group_size=64)))
    assert trep.packed_bytes == jrep.packed_bytes
    assert ({p.replace(f"/{p.split('/')[2]}/", "/", 1)
             for p in trep.quantized} == set(jrep.quantized))
    assert set(trep.calibrated) == set(trep.quantized)
    assert len(trep.quantized) == 7 * cfg.num_layers
    assert set(trep.skipped) == {"frontend/patch_proj", "lm_head"}
    assert set(jrep.skipped) == set(trep.skipped)
    jtree = bridge.params_to_torch(_np(jq), device="cpu")
    disagreed = 0
    for path in trep.quantized:
        _, seg, i, *keys = path.split("/")
        got = tq["segments"][seg][int(i)]
        ref = jtree["segments"][seg][int(i)]
        jone = jq["segments"][seg]
        for k in keys:
            got, ref, jone = got[k], ref[k], jone[k]
        assert isinstance(got, PackedLinear) and isinstance(ref, PackedLinear)
        if not all(torch.equal(getattr(got, f), getattr(ref, f))
                   for f in ("qweight", "zeros")):
            disagreed += 1
            continue
        np.testing.assert_allclose(got.scales.numpy(), ref.scales.numpy(),
                                   rtol=2e-5)
        jone = jax.tree_util.tree_map(lambda a: a[int(i)], jone)
        assert packed_linear_macro_bytes(got) == _macro_bytes_ref(jone), path
    assert disagreed <= 1


def test_full_width_layer_quantizes_the_reference_linears():
    """At the published widths (one layer, a vocabulary of 512: neither
    changes what a layer holds) RTN quantizes the reference's
    ``_quantizable`` linears: seven a layer (q, k, v, o, gate, up, down),
    so 224 over 32 layers; ``patch_proj`` (1,024 → 3,072, excluded by
    name) and ``lm_head`` stay float."""
    cfg = dataclasses.replace(tconfigs.get_config(NAME), num_layers=1,
                              vocab_size=512)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, rep = tpipe.quantize_params(params)
    assert len(rep.quantized) == 7
    assert rep.skipped == ["frontend/patch_proj", "lm_head"]
    assert 7 * tconfigs.get_config(NAME).num_layers == 224


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_cell_costs_equal_reference(size):
    """`cell_costs` of prefill, decode and train cells equals the
    reference's field for field (the reference does not price the
    frontend)."""
    get = {"full": (jconfigs.get_config, tconfigs.get_config),
           "smoke": (jconfigs.get_smoke_config,
                     tconfigs.get_smoke_config)}[size]
    jcfg, tcfg = (g(NAME) for g in get)
    for quant in (False, True):
        for step, s, b in (("prefill", 456, 2), ("prefill", 4096, 1),
                           ("decode", 512, 4), ("decode", 32_768, 128),
                           ("train", 64, 1), ("train", 512, 2)):
            a = jcost.cell_costs(jcfg, jcost.serving_cell(step, s, b), quant)
            c = tcost.cell_costs(tcfg, tcost.serving_cell(step, s, b), quant)
            assert dataclasses.asdict(c) == {
                k: getattr(a, k) for k in dataclasses.asdict(c)}


def test_engine_serves_text_streams_equal_generate():
    """RTN int4 smoke model, bf16 activations: 4 greedy text requests
    through the chunked engine (`submit()` takes tokens only, as in the
    reference) equal the port's own text `generate()` at B 1; the train
    launcher trains the model (3 steps, finite losses)."""
    tm = Model(tconfigs.get_smoke_config(NAME))
    params, _ = tpipe.quantize_params(
        tm.init(torch.Generator().manual_seed(0), device="cpu"))
    eng = GenerationEngine(tm, params, max_seq=64, num_slots=2, page_size=8)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 40, 2, 33)]
    refs = [eng.generate({"tokens": p[None]}, 8)[0] for p in prompts]
    rids = [eng.submit(p, 8) for p in prompts]
    out = eng.drain()
    assert eng._scheduler._run_batch is not None      # chunked
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(out[rid], ref)
    out = tlaunch.main(["--smoke", "--device", "cpu", "--arch", NAME,
                        "--steps", "3"])
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))


def test_launcher_calibrates_on_images_and_generates_text():
    """`launch.serve --smoke --device cpu --arch phi-3-vision-4.2b --quant
    awq`: calibration over tokens and images, AWQ and pack of every
    layer linear (``patch_proj`` never captured, kept float), then a
    text-only `generate()`."""
    out = tserve.main(["--smoke", "--device", "cpu", "--arch", NAME,
                       "--quant", "awq", "--batch", "2", "--prompt-len",
                       "20", "--max-new", "8"])
    rep = out["report"]
    assert out["shape"] == [2, 8]
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert len(rep.quantized) == 14
    assert set(rep.calibrated) == set(rep.quantized)
    assert "frontend/patch_proj" in rep.skipped
