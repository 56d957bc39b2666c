"""Port parity: training every family against the reference's gradients.

For each family the port serves (MoE: qwen2-moe-a2.7b; MLA + MoE:
deepseek-v2-lite-16b; SSM: mamba2-130m; hybrid: hymba-1.5b; encoder:
hubert-xlarge; VLM: phi-3-vision-4.2b), `loss_and_grads` on params
bridged from the reference's ``Model.init(PRNGKey(0))`` and a batch of
the reference's `make_dataset` (the port's gives the same bits) is held
against ``jax.value_and_grad(Model.loss)``: f32 activations, f32 casts,
remat on. Tolerances, each with its reason (`tests/test_torch_train.py`'s
rule): loss, ce and aux at rtol 2e-5 (the same math, sums in another
order; the port's attention is K4's online formula, the reference's a
q-chunked softmax); every gradient leaf within 1e-4 of the leaf's largest
magnitude (a leaf's gradient sums over every token, so its small elements
carry the big ones' rounding); no leaf missing.

Cases: MoE dropless (≤ 1,024 tokens) and in the capacity-factor region
(B 2 × S 544 at ``capacity_factor=1.0``, where tokens are dropped);
deepseek's dense first layer and its MoE layers (MLA); the SSD at S a
multiple of ``ssm_chunk`` and not (the single-chunk path); hubert (its
token table unread: zero gradient, decayed by AdamW as the reference's);
phi-3-vision over image patches and text. hymba and the train
attention's route through K4 / K4b are in `test_torch_train_attention.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import make_dataset as jmake_dataset
from repro.models import build_model
from repro.models import moe as jmoe
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro.training.optim import AdamWConfig as JAdamW
from repro.training.train_step import init_train_state as jinit_state
from repro.utils.tree import flatten_with_paths as jflatten
import repro_torch.configs as tconfigs
from repro_torch.bridge import params_to_torch, state_to_arrays
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.optim import adamw_init
from repro_torch.training.train_step import loss_and_grads, missing_grads


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


def _cfgs(name: str, **kw):
    """The smoke config of both packages at f32 activations, with ``kw``."""
    kw = dict(activation_dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.get_smoke_config(name), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(name), **kw))


def _parity(name: str, b: int, s: int, **kw):
    """One loss and gradient of each package on the same params and batch;
    returns (reference (loss, metrics, grads), port's, jparams, batch)."""
    jcfg, tcfg = _cfgs(name, **kw)
    assert jcfg.remat and tcfg.remat
    jm = build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = jmake_dataset(jcfg, b, s).batch_at(0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jparams, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    params = params_to_torch(_np(jparams), device="cpu")
    loss, metrics, grads = loss_and_grads(
        Model(tcfg), params, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, "float32")
    return (jloss, jmetrics, jgrads), (loss, metrics, grads), jparams, batch


def _assert_parity(ref, port):
    jloss, jmetrics, jgrads = ref
    loss, metrics, grads = port
    assert missing_grads(grads) == []
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=2e-5, atol=1e-12, err_msg=k)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    got = state_to_arrays(grads)
    assert all(np.isfinite(a).all() for a in got.values())
    _leaf_close(got, jgrads)
    return got


# name, B, S, config overrides
CASES = {
    "moe-dropless": ("qwen2-moe-a2.7b", 2, 32, {}),
    "mla-moe": ("deepseek-v2-lite-16b", 2, 32, {}),
    "ssm-chunks": ("mamba2-130m", 2, 64, {}),
    "ssm-one-chunk": ("mamba2-130m", 2, 40, {}),
    "encoder": ("hubert-xlarge", 2, 64, {}),
    "vision": ("phi-3-vision-4.2b", 2, 32, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_family_gradients_match_reference(case):
    name, b, s, kw = CASES[case]
    ref, port, _, _ = _parity(name, b, s, **kw)
    got = _assert_parity(ref, port)
    cfg = tconfigs.get_smoke_config(name)
    if cfg.num_experts:               # the MoE layers' aux loss enters
        assert float(port[1]["aux"]) > 0
        assert any("/experts/" in p for p in got)
    if case == "mla-moe":             # the dense first layer and MLA's own
        assert {"segments/seg_0/mlp/gate/w", "segments/seg_0/attn/kv_up/w",
                "segments/seg_1/attn/kv_down/w",
                "segments/seg_1/moe/router/w"} <= set(got)
    if case == "encoder":             # the token table: read by nothing
        assert not got["embed/table"].any()
    if case == "vision":              # the patches' projection is read
        assert np.abs(got["frontend/patch_proj/w"]).max() > 0


def test_moe_gradients_match_reference_where_tokens_drop():
    """B 2 × S 544 (1,088 tokens, past the dropless 1,024) at
    ``capacity_factor=1.0``: the capacity-factor formula's buffer drops
    some tokens' choices; loss, aux and every gradient still match."""
    ref, port, jparams, batch = _parity("qwen2-moe-a2.7b", 2, 544,
                                        capacity_factor=1.0)
    _assert_parity(ref, port)
    # the first MoE layer's routing on its own input drops choices in
    # both packages' formulas: count them from the router's probabilities
    _, tcfg = _cfgs("qwen2-moe-a2.7b", capacity_factor=1.0)
    jcfg, _ = _cfgs("qwen2-moe-a2.7b", capacity_factor=1.0)
    t = 2 * 544
    cap = tmoe.capacity(tcfg, t)
    assert cap == jmoe.capacity(jcfg, t) < t
    rng = np.random.default_rng(0)
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((t, tcfg.num_experts)).astype(np.float32)), -1)
    _, _, _, keeps = tmoe.route(probs, tcfg, cap)
    assert not bool(torch.stack(keeps).all())


def test_hubert_train_step_decays_the_unread_table():
    """One AdamW step with weight decay 0.1 on hubert's smoke config: new
    params and both moments within 1e-4 of each leaf's largest magnitude
    of the reference's `make_train_step` (the step's rule in
    `tests/test_torch_train.py`: a param also gets up to 2 lr where its
    gradient is small), ``embed/table`` included: zero gradient, zero
    moments, and the table shrunk by ``lr · wd``."""
    jcfg, tcfg = _cfgs("hubert-xlarge")
    opt = dict(lr=1e-3, warmup_steps=0, decay_steps=10, weight_decay=0.1)
    jm = build_model(jcfg)
    jstate = jinit_state(jm, jax.random.PRNGKey(0))
    batch = jmake_dataset(jcfg, 2, 32).batch_at(0)
    jnew, _ = jax.jit(jmake_train_step(jm, JTrainConfig(
        optimizer=JAdamW(**opt), grad_comm_dtype="float32")))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_to_torch(_np(jstate["params"]), device="cpu")
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    table0 = params["embed"]["table"].clone()
    new, _ = make_train_step(Model(tcfg), TrainConfig(
        optimizer=AdamWConfig(**opt), grad_comm_dtype="float32"))(state,
                                                                   batch)
    got = state_to_arrays(new["params"])
    for path, w in jflatten(jnew["params"]):
        w = np.asarray(w, np.float64)
        lim = 1e-4 * np.abs(w).max() + 2 * opt["lr"]
        assert np.abs(got[path] - w).max() <= lim, path
    np.testing.assert_allclose(got["embed/table"],
                               np.asarray(jnew["params"]["embed"]["table"]),
                               rtol=1e-6, atol=0)
    # lr at step 0 with no warmup is the peak: p (1 - lr wd), exactly the
    # decay (no moment moves the table)
    np.testing.assert_allclose(
        got["embed/table"], (table0 * (1 - opt["lr"] * opt["weight_decay"])
                             ).numpy(), rtol=1e-6)
    for moment in ("m", "v"):
        arrs = state_to_arrays(new["opt"][moment])
        assert not arrs["embed/table"].any()
        _leaf_close(arrs, jnew["opt"][moment])


def test_unread_leaves():
    """Only the leaves a batch never reads: hubert's table; phi-3-vision's
    ``patch_proj`` without images, none with them; none for a decoder."""
    def unread(name, batch):
        m = Model(tconfigs.get_smoke_config(name))
        return m.unread_leaves(m.init(torch.Generator().manual_seed(0),
                                      device="cpu"), batch)
    assert unread("hubert-xlarge", {}) == ["embed/table"]
    assert unread("phi-3-vision-4.2b", {"tokens": 0}) == [
        "frontend/patch_proj/b", "frontend/patch_proj/w"]
    assert unread("phi-3-vision-4.2b", {"images": 0}) == []
    assert unread("qwen2-moe-a2.7b", {}) == []


def test_vision_batch_without_images_gets_zero_patch_gradients():
    """A text-only batch of phi-3-vision: ``patch_proj`` gets zeros (as
    `jax.grad` gives them), every other leaf matches the reference."""
    jcfg, tcfg = _cfgs("phi-3-vision-4.2b")
    jm = build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = jmake_dataset(jcfg, 2, 32).batch_at(0)
    del batch["images"]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = loss_and_grads(
        Model(tcfg), params_to_torch(_np(jparams), device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, "float32")
    assert missing_grads(grads) == []
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    got = state_to_arrays(grads)
    assert not got["frontend/patch_proj/w"].any()
    _leaf_close(got, jgrads)
