"""Port parity: the reference's encoder, hubert-xlarge, on its smoke
config — stub frame features ``[B, S, frontend_dim]`` through
``frame_proj``, a bidirectional stack (LayerNorm, MHA without RoPE, a
plain GELU MLP) and an untied head over the codebook vocabulary at every
frame.

The reference's params (`Model.init` with a `jax.random` key) are carried
over by `bridge.params_to_torch`; batches come from both data pipelines
(equal element for element) or from numpy with a seed. With f32
activations on both sides the tolerance is the reference's f32 kernel
tolerance (rtol / atol 2e-5, `tests/test_kernels.py:40`):
`forward_logits`, `prefill` (logits ``[B, S, V]`` and the KV cache the
reference writes for an encoder too) and `loss`. Attention reaches K4's
wrapper with ``causal=False`` in the train and prefill modes and does no
rotary work (``rope_fraction`` 0). Quantization runs both pipelines on
the reference's calibration stats: the same linears (``frame_proj``
quantized at RTN, since the capture never sees it; ``lm_head`` float),
words, zeros and AWQ_MACRO bytes. `cell_costs` of prefill cells equals
the reference's; the engine, an encoder's decode cells and the train
launcher refuse the encoder; the serve launcher ends after packing.
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
from repro.models import layers as jlayers
from repro.roofline import costmodel as jcost
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import awq as tawq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear, packed_linear_macro_bytes
from repro_torch.core.qlinear import ExecutionConfig, execution_config
from repro_torch.core.quantize import QuantConfig
from repro_torch.data.pipeline import make_dataset
from repro_torch.kernels import flash_attention as k4
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention, layers
from repro_torch.models.model import Model
from repro_torch.roofline import costmodel as tcost
from repro_torch.serving.engine import GenerationEngine

NAME = "hubert-xlarge"
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


def _features(seed, b, s, dim=32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, dim)).astype(np.float32)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_reference(get):
    """Both configs equal the reference's field for field, with its layer
    kinds: every layer bidirectional attention with a plain MLP."""
    j, t = getattr(jconfigs, get)(NAME), getattr(tconfigs, get)(NAME)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ([dataclasses.asdict(k) for k in t.layer_kinds()]
            == [dataclasses.asdict(k) for k in j.layer_kinds()])
    assert t.n_params() == j.n_params()
    assert t.is_encoder and t.frontend == "audio" and t.rope_fraction == 0
    assert {(k.mixer, k.mlp) for k in t.layer_kinds()} == {("attn", "plain")}


@pytest.mark.parametrize("step", [0, 3])
def test_batches_equal_reference(step):
    """The audio batch (band-limited noise features, codeword labels)
    equals the reference's element for element, at two steps."""
    cfg = tconfigs.get_smoke_config(NAME)
    got = make_dataset(cfg, 3, 40, seed=7).batch_at(step)
    want = jmake(jconfigs.get_smoke_config(NAME), 3, 40, seed=7).batch_at(
        step)
    assert got.keys() == want.keys() == {"features", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_bridged_params_have_the_port_layout(models):
    """The bridged reference params (``frontend/frame_proj`` with its
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
    assert set(own["frontend"]["frame_proj"]) == {"w", "b"}


def test_forward_prefill_and_loss_match_reference(models):
    """`forward_logits` and `prefill` over [2, 40] frames give logits at
    every frame ``[B, S, V]``, equal to each other and to the
    reference's; the prefill's KV cache (written for an encoder too, here
    at the batch's S) and next position equal the reference's; `loss`
    over the same frames and codeword labels too."""
    jm, jp, tm, tp = models
    feats = _features(1, 2, 40)
    labels = np.random.default_rng(2).integers(0, 64, (2, 40)).astype(
        np.int32)
    labels[0, :5] = -1
    jb = {"features": jnp.asarray(feats)}
    tb = {"features": torch.from_numpy(feats)}
    jl = jm.forward_logits(jp, jb)
    tl = tm.forward_logits(tp, tb)
    assert tl.shape == (2, 40, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jc, jpl, jpos = jm.prefill(jp, jb, jm.init_cache(2, 40,
                                                     dtype=jnp.float32))
    tc, tpl, tpos = tm.prefill(tp, tb, tm.init_cache(2, 40,
                                                     dtype=torch.float32,
                                                     device="cpu"))
    assert tpl.shape == (2, 40, 64)
    np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), **F32)
    assert torch.equal(tpl, tl)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jcn = _np(jc)
    for seg, lyrs in tc.items():
        for i, entry in enumerate(lyrs):
            for leaf, got in entry["kv"].items():
                np.testing.assert_allclose(
                    got.numpy(), jcn[seg]["kv"][leaf][i], **F32)
    jloss, jaux = jm.loss(jp, {"features": jnp.asarray(feats),
                               "labels": jnp.asarray(labels)})
    tloss, taux = tm.loss(tp, {"features": torch.from_numpy(feats),
                               "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 75.0


def test_attention_is_bidirectional_without_rope(models, monkeypatch):
    """Every layer's attention reaches K4's wrapper with ``causal=False``
    in the train mode (`forward_logits`, `loss`) and the prefill mode,
    and no rotary table is built (``rope_fraction`` 0: ``rd`` 0)."""
    _, _, tm, tp = models
    seen = []
    plain = k4.flash_attention

    def spy(*args, causal=True, **kw):
        seen.append(causal)
        return plain(*args, causal=causal, **kw)

    def no_rope(*args, **kw):
        raise AssertionError("rotary work on an encoder without RoPE")

    monkeypatch.setattr(k4, "flash_attention", spy)
    monkeypatch.setattr(attention, "rope_cos_sin", no_rope)
    assert attention._rot_dim(tm.cfg) == 0
    tb = {"features": torch.from_numpy(_features(3, 1, 24))}
    tm.forward_logits(tp, tb)
    tm.prefill(tp, tb, tm.init_cache(1, 24, dtype=torch.float32,
                                     device="cpu"))
    tm.loss(tp, {**tb, "labels": torch.zeros((1, 24), dtype=torch.int32)})
    assert seen == [False] * (3 * tm.cfg.num_layers)


@pytest.mark.parametrize("op", ["gelu", "layernorm"])
def test_gelu_and_layernorm_match_reference_at_full_width(op):
    """The plain MLP's GELU (tanh approximation, as ``jax.nn.gelu``) over
    hubert's d_ff 5,120 and LayerNorm (eps 1e-5) over its d_model 1,280,
    against the reference's, at f32 tolerance."""
    cfg = tconfigs.get_config(NAME)
    rng = np.random.default_rng(5)
    if op == "gelu":
        x = (rng.standard_normal((6, cfg.d_ff)) * 3).astype(np.float32)
        got = layers.activation("gelu", torch.from_numpy(x)).numpy()
        want = np.asarray(jlayers.activation("gelu", jnp.asarray(x)))
    else:
        x = (rng.standard_normal((6, cfg.d_model)) * 2 + 0.5).astype(
            np.float32)
        p = {"gamma": rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32),
             "beta": rng.standard_normal(cfg.d_model).astype(np.float32)}
        got = layers.norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), cfg).numpy()
        want = np.asarray(jlayers.norm({k: jnp.asarray(v)
                                        for k, v in p.items()},
                                       jnp.asarray(x), cfg))
    np.testing.assert_allclose(got, want, **F32)


def _macro_bytes_ref(p) -> bytes:
    return jpack.awq_macro_bytes(np.asarray(jpack.unpack_int4(p.qweight)),
                                 np.asarray(p.scales), np.asarray(p.zeros),
                                 p.group_size)


def test_awq_quantized_trees_equal_reference():
    """Both pipelines quantize the same float params with the reference's
    calibration stats (AWQ, GS 64; ``frontend_dim`` 128 on both sides so
    that ``frame_proj`` is quantizable, as at the published 512): the same
    linears and bytes; every layer linear calibrated, ``frame_proj``
    quantized at RTN (the capture never records it), ``lm_head`` float;
    every linear whose searched scale agrees packs equal words, zeros and
    AWQ_MACRO bytes (a pick may differ only on a tie of the candidate
    losses: at most one linear)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(NAME),
                               frontend_dim=128)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(NAME),
                               frontend_dim=128)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = bridge.params_to_torch(_np(jp), device="cpu")
    batch = jmake(jcfg, 2, 64, seed=123).batch_at(0)
    np.testing.assert_array_equal(
        make_dataset(tcfg, 2, 64, seed=123).batch_at(0)["features"],
        batch["features"])
    with jcal.CalibrationCapture() as cap:
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert not any("frontend" in k for k in cap.stats)
    qcfg = dict(quant=QuantConfig(group_size=64))
    jq, jrep = jpipe.quantize_params(
        jp, cap.stats, jawq.AWQConfig(quant=JQuantConfig(group_size=64)))
    tq, trep = tpipe.quantize_params(tp, cap.stats, tawq.AWQConfig(**qcfg))
    assert trep.packed_bytes == jrep.packed_bytes
    layer = {p for p in trep.quantized if p.startswith("segments/")}
    assert ({p.replace(f"/{p.split('/')[2]}/", "/", 1) for p in layer}
            | (set(trep.quantized) - layer)) == set(jrep.quantized)
    assert "frontend/frame_proj" in trep.quantized
    assert set(trep.calibrated) == layer
    assert set(trep.skipped) == {"lm_head"} == set(jrep.skipped)
    assert len(layer) == 6 * tcfg.num_layers
    jtree = bridge.params_to_torch(_np(jq), device="cpu")
    disagreed = 0
    for path in trep.quantized:
        keys = path.split("/")
        got, ref, jone = tq, jtree, jq
        if keys[0] == "segments":
            _, seg, i, *rest = keys
            got = tq["segments"][seg][int(i)]
            ref = jtree["segments"][seg][int(i)]
            jone = jq["segments"][seg]
            keys = rest
        for k in keys:
            got, ref, jone = got[k], ref[k], jone[k]
        if path.startswith("segments/"):
            jone = jax.tree_util.tree_map(lambda a: a[int(i)], jone)
        assert isinstance(got, PackedLinear) and isinstance(ref, PackedLinear)
        if not all(torch.equal(getattr(got, f), getattr(ref, f))
                   for f in ("qweight", "zeros")):
            disagreed += 1
            continue
        np.testing.assert_allclose(got.scales.numpy(), ref.scales.numpy(),
                                   rtol=2e-5)
        if path == "frontend/frame_proj":
            assert torch.equal(got.input_scale,
                               torch.ones_like(got.input_scale))
            assert torch.equal(got.bias, ref.bias)
        assert packed_linear_macro_bytes(got) == _macro_bytes_ref(jone), path
    assert disagreed <= 1


def test_full_width_layer_quantizes_the_reference_linears():
    """At the published widths (one layer: the count is per layer) RTN
    quantizes the reference's ``_quantizable`` linears: six a layer (q,
    k, v, o, up, down) and ``frame_proj`` (512 → 1,280), so 289 over 48
    layers; ``lm_head`` (1,280 → 504) stays float."""
    cfg = dataclasses.replace(tconfigs.get_config(NAME), num_layers=1)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, rep = tpipe.quantize_params(params)
    assert len(rep.quantized) == 7 and rep.skipped == ["lm_head"]
    assert "frontend/frame_proj" in rep.quantized
    per_layer = len(rep.quantized) - 1
    assert per_layer * tconfigs.get_config(NAME).num_layers + 1 == 289


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_cell_costs_equal_reference(size):
    """`cell_costs` of prefill cells equals the reference's field for
    field: the plain MLP's two linears, the head at every frame, its
    table counted once, and the reference's causal pair count ``S · S /
    2`` for the bidirectional layers. An encoder's decode cells raise
    (no decode step); a train cell equals the reference's (the head at
    every frame, the backward's factors)."""
    get = {"full": (jconfigs.get_config, tconfigs.get_config),
           "smoke": (jconfigs.get_smoke_config,
                     tconfigs.get_smoke_config)}[size]
    jcfg, tcfg = (g(NAME) for g in get)
    for quant in (False, True):
        for s, b in ((200, 1), (1024, 2), (32_768, 32)):
            a = jcost.cell_costs(jcfg, jcost.serving_cell("prefill", s, b),
                                 quant)
            c = tcost.cell_costs(tcfg, tcost.serving_cell("prefill", s, b),
                                 quant)
            assert dataclasses.asdict(c) == {
                k: getattr(a, k) for k in dataclasses.asdict(c)}
    with pytest.raises(ValueError, match="no autoregressive decode step"):
        tcost.cell_costs(tcfg, tcost.serving_cell("decode", 512), False)
    for quant in (False, True):
        a = jcost.cell_costs(jcfg, jcost.serving_cell("train", 64), quant)
        c = tcost.cell_costs(tcfg, tcost.serving_cell("train", 64), quant)
        assert dataclasses.asdict(c) == {
            k: getattr(a, k) for k in dataclasses.asdict(c)}


def test_engine_and_train_launcher_refuse_the_encoder():
    """`GenerationEngine` on an encoder raises with the reference's words
    (``skipped_cells``: "encoder-only: no autoregressive decode step");
    the train launcher trains it (3 steps, finite losses)."""
    tm = Model(tconfigs.get_smoke_config(NAME))
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="encoder-only: no autoregressive "
                                         "decode step"):
        GenerationEngine(tm, params, max_seq=32)
    assert jconfigs.skipped_cells(NAME)["decode_32k"] == (
        "encoder-only: no autoregressive decode step")
    out = tlaunch.main(["--smoke", "--device", "cpu", "--arch", NAME,
                        "--steps", "3"])
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))


def test_launcher_quantizes_then_ends_without_decode(capsys):
    """`launch.serve --smoke --device cpu --arch hubert-xlarge --quant
    awq`: calibration over the features batch, AWQ and pack of every
    layer linear (the smoke ``frame_proj``, 32 → 128, is below the
    pipeline's size rule and stays float, as in the reference), then the
    end line; no tokens are generated."""
    out = tserve.main(["--smoke", "--device", "cpu", "--arch", NAME,
                       "--quant", "awq"])
    rep = out["report"]
    assert "tokens" not in out and "params" in out
    assert len(rep.quantized) == 12 and set(rep.calibrated) == set(
        rep.quantized)
    assert set(rep.skipped) == {"frontend/frame_proj", "lm_head"}
    assert out["launches"]["calibrate"]["flash_attention"] == 0  # CPU
    assert "encoder-only: no autoregressive decode step" in (
        capsys.readouterr().out)
