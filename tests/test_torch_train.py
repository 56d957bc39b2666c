"""Port parity: the train step, AdamW and the data stream against the
reference's `training/` (the same params, bridged from the reference's
``Model.init(PRNGKey(0))``, the same batches: both packages'
`make_dataset` give the same bits).

Tolerances, each with its reason:
  * f32 activations, f32 gradient casts: loss and ce at rtol 2e-5 (the
    reference's f32 tolerance: the same math, sums in another order; the
    port's attention is K4's online formula, the reference's a q-chunked
    softmax); every gradient leaf, the new params and both moments within
    1e-4 of that leaf's largest magnitude (a leaf's gradient sums over
    every token, so its small elements carry the big ones' rounding);
    grad_norm and lr at rtol 1e-5.
  * bf16 activations (the default), both gradient casts: losses within
    2e-2 relative (both round activations to bf16 at other places: K4
    keeps f32 probabilities where the reference rounds them to bf16).
  * `adamw_update` on the same numpy params and grads: rtol 1e-6 (the
    same f32 formula, term for term).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.data import make_dataset as jmake_dataset
from repro.models import build_model
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro.training.optim import AdamWConfig as JAdamW
from repro.training.optim import adamw_init as jadamw_init
from repro.training.optim import adamw_update as jadamw_update
from repro.training.train_step import init_train_state as jinit_state
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import configs
from repro_torch.bridge import params_to_torch, state_to_arrays
from repro_torch.data.pipeline import make_dataset
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.optim import (adamw_init, adamw_update,
                                        clip_by_global_norm, global_norm,
                                        lr_at)
from repro_torch.training.train_step import (init_train_state,
                                             loss_and_grads, missing_grads,
                                             train_state_shapes)
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=10, weight_decay=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and a train step's many small ops otherwise spin
    on oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate):
    params = params_to_torch(_np(jstate["params"]), device="cpu")
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _leaf_close(got: dict, want, bound: float = 1e-4):
    """Every reference leaf present in ``got`` and within ``bound`` of the
    leaf's largest magnitude."""
    want = dict(jflatten(want))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[path], np.float64)
        assert g.shape == w.shape, path
        lim = bound * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= lim, (path, np.abs(g - w).max(), lim)


@pytest.fixture(scope="module")
def f32_step():
    """One step of each package at f32 activations and f32 casts."""
    cfg = dataclasses.replace(C.get_smoke_config("qwen25-05b"),
                              activation_dtype="float32")
    jm = build_model(cfg)
    jstate = jinit_state(jm, jax.random.PRNGKey(0))
    batch = jmake_dataset(cfg, 4, 32).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jstate["params"], jbatch)
    jnew, jstep_metrics = jax.jit(jmake_train_step(jm, JTrainConfig(
        optimizer=JAdamW(**OPT), grad_comm_dtype="float32")))(jstate, jbatch)

    tcfg = dataclasses.replace(configs.get_smoke_config("qwen25-05b"),
                               activation_dtype="float32")
    model = Model(tcfg)
    state = _port_state(jstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = loss_and_grads(model, state["params"], tbatch,
                                          "float32")
    new, step_metrics = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**OPT), grad_comm_dtype="float32"))(state,
                                                                   batch)
    return dict(jloss=jloss, jmetrics=jmetrics, jgrads=jgrads, jnew=jnew,
                jstep_metrics=jstep_metrics, loss=loss, metrics=metrics,
                grads=grads, new=new, step_metrics=step_metrics)


def test_loss_matches_reference(f32_step):
    r = f32_step
    np.testing.assert_allclose(float(r["loss"]), float(r["jloss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(r["metrics"]["ce"]),
                               float(r["jmetrics"]["ce"]), rtol=2e-5)
    assert float(r["metrics"]["tokens"]) == float(r["jmetrics"]["tokens"])
    np.testing.assert_allclose(float(r["step_metrics"]["loss"]),
                               float(r["jstep_metrics"]["loss"]), rtol=2e-5)


def test_every_gradient_leaf_present_finite_and_close(f32_step):
    grads = f32_step["grads"]
    assert missing_grads(grads) == []
    got = state_to_arrays(grads)
    assert all(np.isfinite(a).all() for a in got.values())
    # the attention's own weights: a cut graph would leave them at None
    assert {"segments/seg_0/attn/wq/w", "segments/seg_0/attn/wk/w",
            "segments/seg_0/attn/wv/w", "segments/seg_0/attn/wq/b"} <= set(got)
    _leaf_close(got, f32_step["jgrads"])


def test_new_params_and_moments_close(f32_step):
    """Moments as the gradients. The first step moves a param by
    ``lr · g / (|g| + eps)``, about lr whatever the gradient's size, so a
    gradient error δ (the gradient's bound, 1e-4 of its leaf's largest
    magnitude) can move that step by up to ``min(2, 2 δ / |g|)`` lr, and
    by 2 lr where the gradient lies within δ of zero and may change
    sign: each param element is held to 1e-4 of its leaf's largest
    magnitude plus that."""
    r = f32_step
    got = state_to_arrays(r["new"]["params"])
    grads = dict(jflatten(r["jgrads"]))
    for path, w in jflatten(r["jnew"]["params"]):
        w = np.asarray(w, np.float64)
        g = np.abs(np.asarray(grads[path], np.float64))
        delta = 1e-4 * g.max()
        step_err = np.minimum(2.0, 2 * delta / np.maximum(g, 1e-30))
        lim = 1e-4 * np.abs(w).max() + OPT["lr"] * step_err
        assert (np.abs(got[path] - w) <= lim).all(), path
    _leaf_close(state_to_arrays(r["new"]["opt"]["m"]), r["jnew"]["opt"]["m"])
    _leaf_close(state_to_arrays(r["new"]["opt"]["v"]), r["jnew"]["opt"]["v"])
    assert int(r["new"]["step"]) == int(r["jnew"]["step"]) == 1
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(r["step_metrics"][k]),
                                   float(r["jstep_metrics"][k]), rtol=1e-5)


@pytest.mark.parametrize("comm", ["float32", "bfloat16"])
def test_bf16_activation_losses_close_to_reference(comm):
    cfg = C.get_smoke_config("qwen25-05b")
    jm = build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = jmake_dataset(cfg, 4, 32).batch_at(1)
    dt = jnp.dtype(comm)

    def jloss(p, b):
        p = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.float32
                         and a.ndim >= 2 else a, p)
        return jm.loss(p, b)[0]
    want = float(jax.jit(jloss)(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()}))
    model = Model(configs.get_smoke_config("qwen25-05b"))
    params = params_to_torch(_np(jparams), device="cpu")
    loss, _, grads = loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        comm)
    assert missing_grads(grads) == []
    assert abs(float(loss) - want) <= 2e-2 * abs(want)


def test_bf16_grad_comm_close_to_f32():
    """bf16 gradient casts stay close to the f32 baseline over a few steps
    (the reference's test, on the port)."""
    cfg = configs.get_smoke_config("smollm-360m")
    m = Model(cfg)
    ds = make_dataset(cfg, 4, 32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=50,
                      weight_decay=0.0)
    outs = {}
    for dt in ("float32", "bfloat16"):
        state = init_train_state(m, torch.Generator().manual_seed(0),
                                 device="cpu")
        step = make_train_step(m, TrainConfig(optimizer=opt,
                                              grad_comm_dtype=dt))
        for i in range(5):
            state, metrics = step(state, ds.batch_at(i))
        outs[dt] = float(metrics["loss"])
    assert abs(outs["bfloat16"] - outs["float32"]) < 0.05


def test_loss_descends_on_markov_stream():
    """20 steps at the reference's descent settings (remat on)."""
    cfg = configs.get_smoke_config("qwen25-05b")
    assert cfg.remat
    m = Model(cfg)
    state = init_train_state(m, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(m, TrainConfig(optimizer=AdamWConfig(
        lr=3e-3, warmup_steps=2, decay_steps=200, weight_decay=0.0)))
    ds = make_dataset(cfg, 8, 64)
    losses = []
    for i in range(20):
        state, metrics = step(state, ds.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3


@pytest.mark.parametrize("name", [
    "qwen25-05b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "mamba2-130m",
    "hymba-1.5b", "hubert-xlarge", "phi-3-vision-4.2b"])
def test_remat_gives_the_same_gradients(name):
    """Per-block checkpointing recomputes the forward in the backward: the
    loss and every gradient equal the run without it, bit for bit, under
    every block kind (attention + MoE with its aux loss, MLA + MoE, the
    SSD, hymba's attention ∥ SSD, the encoder's plain MLP, a decoder
    behind image patches)."""
    cfg = configs.get_smoke_config(name)
    params = Model(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in make_dataset(cfg, 2, 16).batch_at(0).items()}
    out = {}
    for remat in (True, False):
        m = Model(dataclasses.replace(cfg, remat=remat))
        loss, _, grads = loss_and_grads(m, params, batch)
        out[remat] = (loss, state_to_arrays(grads))
    assert torch.equal(out[True][0], out[False][0])
    for path, a in out[True][1].items():
        np.testing.assert_array_equal(a, out[False][1][path], err_msg=path)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_at(cfg, 0)) == 0.0
    assert abs(float(lr_at(cfg, 10)) - 1e-3) < 1e-9
    assert float(lr_at(cfg, 55)) < 1e-3
    assert abs(float(lr_at(cfg, 100)) - 1e-4) < 1e-8


def test_grad_clip():
    g = {"a": torch.ones(10) * 100.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert abs(float(norm) - np.sqrt(10) * 100) < 1e-2


def test_adamw_update_matches_reference():
    """Three steps on the same numpy params and grads, with clipping,
    warmup, decay and weight decay all active."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "layers": (3, 4, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=6, weight_decay=0.1,
              grad_clip=1.0)
    jp, jo = p, jadamw_init(p)
    tp = {"w": torch.from_numpy(p["w"]), "b": torch.from_numpy(p["b"]),
          "layers": [torch.from_numpy(a) for a in p["layers"]]}
    to = adamw_init(tp)
    for step in range(3):
        g = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
             for k, s in shapes.items()}
        jp, jo, jm = jadamw_update(jp, g, jo, jnp.asarray(step, jnp.int32),
                                   JAdamW(**kw))
        tg = {"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"]),
              "layers": [torch.from_numpy(a) for a in g["layers"]]}
        tp, to, tm = adamw_update(tp, tg, to, step, AdamWConfig(**kw))
        for name, got, want in (("params", tp, jp), ("m", to["m"], jo["m"]),
                                ("v", to["v"], jo["v"])):
            arrs = state_to_arrays(got)
            for k in shapes:
                np.testing.assert_allclose(arrs[k], np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=f"{name}/{k}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    # the reference's leaf order: "b", "layers", "w" (sorted keys)
    assert [p for p, _ in flatten_with_paths(tp)] == ["b", "layers", "w"]
    assert float(global_norm(tp)) > 0


def test_state_shapes_paths_and_bytes_equal_reference():
    jm = build_model(C.get_smoke_config("qwen25-05b"))
    jshapes = jax.eval_shape(lambda: jinit_state(jm, jax.random.PRNGKey(0)))
    shapes = train_state_shapes(Model(configs.get_smoke_config(
        "qwen25-05b")))
    flat = flatten_with_paths(shapes)
    assert all(t.device.type == "meta" for _, t in flat)
    assert [p for p, _ in flat] == [p for p, _ in jflatten(jshapes)]
    for (_, t), (_, s) in zip(flat, jflatten(jshapes)):
        assert tuple(t.shape) == tuple(s.shape)
        assert str(t.dtype).split(".")[-1] == np.dtype(s.dtype).name
    from repro.utils.tree import leaf_bytes as jleaf_bytes
    assert leaf_bytes(shapes) == jleaf_bytes(jshapes)


def test_dataset_iter_and_host_slice_equal_reference():
    cfg = configs.get_smoke_config("qwen25-05b")
    jds = jmake_dataset(C.get_smoke_config("qwen25-05b"), 4, 16, seed=3)
    ds = make_dataset(cfg, 4, 16, seed=3)
    for (got, want), _ in zip(zip(ds, jds), range(3)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    b = ds.batch_at(5)
    for host in range(2):
        got, want = ds.host_slice(b, host, 2), jds.host_slice(b, host, 2)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
