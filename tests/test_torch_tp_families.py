"""Tensor-parallel training of the MLA, SSM, hybrid, encoder and VLM
families in the port, held against the JAX package's unsharded step.

The smoke configs of `test_torch_tp_families_forward.py` (deepseek-v2-
lite, mamba2, hymba, hubert, phi-3-vision, and hymba with an odd
vocabulary, whose tied table splits over d) under (1 × 2), (2 × 2) and
(1 × 4). Tolerances (`tests/test_torch_train.py`'s, with their reasons
there): f32 activations and f32 gradient casts — loss rtol 2e-5; every
gradient leaf and both moments within 1e-4 of the leaf's largest
magnitude; new params within that plus the first Adam step's sign
allowance.

  * one step from bridged reference params against the reference's
    unsharded step (hubert's unread token table: a zero gradient on
    every shard; phi-3-vision's batch carries its patches);
  * the hazard: hymba with SSM heads of 128 at ``model`` 4 (a stripe
    cuts a head, the heads run joined on the first shard). Its ``a_log``
    gradients move by up to 1e-4 of their largest magnitude when the
    params move by 1e-7 (f32 rounding's scale: the port's unsharded step
    is 6e-5 from the reference's there, its moments twice that), so the
    sharded step is held against the port's unsharded one on the same
    params: the loss bit-equal (on the CPU the partial products stay in
    float64 until one rounding), within 2e-5 of the reference's, every
    gradient leaf within 1e-4 of its largest magnitude;
  * every replicated leaf (the conv kernels, ``a_log``, ``ssm_d``,
    ``dt_bias``, ``out_norm``, MLA's ``kv_norm``, the norms) bit-equal
    to its first shard's copy after 3 steps at (2 × 2), and each split
    leaf exactly 1 / |model| of its logical bytes;
  * a mesh state of hymba (2 × 2) saves the reference's paths and
    shapes and restores onto (1 × 4), whose next loss is the first
    mesh's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dataset as jmake_dataset
from repro.models import build_model
from repro.training import TrainConfig as JTrainConfig
from repro.training import make_train_step as jmake_train_step
from repro.training.optim import AdamWConfig as JAdamW
from repro.training.train_step import init_train_state as jinit_state
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch.bridge import params_to_torch, state_to_arrays
from repro_torch.checkpoint import restore, save
from repro_torch.data.pipeline import make_dataset
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.optim import adamw_init
from repro_torch.training.train_step import (loss_and_grads, reduce_grads,
                                             train_state_shapes)
from repro_torch.utils.tree import layer_parts, map_tree
from test_torch_tp_families_forward import configs_of

OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=10, weight_decay=0.1)
ARCHS = ["deepseek", "mamba2", "hymba", "hubert", "phi3v", "hymba-v511",
         "hymba-hd128"]
MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(data, model):
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


def _port_state(jstate):
    params = params_to_torch(_np(jstate["params"]), device="cpu")
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.fixture(scope="module", params=ARCHS[:-1])
def ref(request):
    """The reference's unsharded f32 step: loss, gradients, new state."""
    jcfg, tcfg = configs_of(request.param)
    jm = build_model(jcfg)
    jstate = jinit_state(jm, jax.random.PRNGKey(0))
    batch = jmake_dataset(jcfg, 4, 64).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jstate["params"], jbatch)
    jnew, _ = jax.jit(jmake_train_step(jm, JTrainConfig(
        optimizer=JAdamW(**OPT), grad_comm_dtype="float32")))(jstate, jbatch)
    return dict(key=request.param, model=Model(tcfg), jstate=jstate,
                batch=batch, jloss=jloss, jgrads=jgrads, jnew=jnew)


def _leaf_close(got: dict, want, bound: float = 1e-4):
    want = dict(jflatten(want))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[path], np.float64)
        assert g.shape == w.shape, path
        lim = bound * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= lim, (path, np.abs(g - w).max(), lim)


def _logical(stripes, specs):
    return map_tree(lambda sp, *ts: shd.join_pieces(list(ts), sp[0], "cpu"),
                    specs, *stripes)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2", "1x4"])
def test_sharded_step_matches_reference(ref, shape):
    model = ref["model"]
    mesh = _mesh(*shape)
    state = shd.TrainSharding(mesh, model.cfg).place(
        _port_state(ref["jstate"]))
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, _, grads = loss_and_grads(model, state["params"], batch,
                                    "float32", mesh=mesh)
    np.testing.assert_allclose(float(loss), float(ref["jloss"]), rtol=2e-5)
    unread = model.unread_leaves(state["params"][0][0], batch)
    for r, m in np.ndindex(*shape):
        for path, parts, leaf in layer_parts(grads[r][m]):
            if path in unread:       # hubert's token table, every shard
                assert leaf is not None and not leaf.any(), (path, r, m)
    devices = [list(rm.devices) for rm in state.sharding.replicas]
    stripes, _ = reduce_grads(grads, state.specs, "float32", devices)
    _leaf_close(state_to_arrays(_logical(stripes, state.specs)),
                ref["jgrads"])

    new, met = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**OPT), grad_comm_dtype="float32"),
        mesh=mesh)(state, ref["batch"])
    np.testing.assert_allclose(float(met["loss"]), float(ref["jloss"]),
                               rtol=2e-5)
    logical = new.logical()
    got = state_to_arrays(logical["params"])
    jg = dict(jflatten(ref["jgrads"]))
    for path, w in jflatten(ref["jnew"]["params"]):
        w = np.asarray(w, np.float64)
        g = np.abs(np.asarray(jg[path], np.float64))
        step_err = np.minimum(2.0, 2 * 1e-4 * g.max() / np.maximum(g, 1e-30))
        lim = 1e-4 * np.abs(w).max() + OPT["lr"] * step_err
        assert (np.abs(got[path] - w) <= lim).all(), path
    _leaf_close(state_to_arrays(logical["opt"]["m"]), ref["jnew"]["opt"]["m"])
    _leaf_close(state_to_arrays(logical["opt"]["v"]), ref["jnew"]["opt"]["v"])


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
def test_head_cutting_stripe_step_matches_unsharded(shape):
    jcfg, tcfg = configs_of("hymba-hd128")
    jm = build_model(jcfg)
    jstate = jinit_state(jm, jax.random.PRNGKey(0))
    batch = jmake_dataset(jcfg, 4, 64).batch_at(0)
    jloss, _ = jax.jit(jm.loss)(jstate["params"],
                                {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(tcfg)
    assert model.cfg.ssm_nheads % shape[1]      # the stripe cuts a head
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_loss, _, want = loss_and_grads(
        model, _port_state(jstate)["params"], tb, "float32")
    mesh = _mesh(*shape)
    state = shd.TrainSharding(mesh, model.cfg).place(
        _port_state(jstate))
    loss, _, grads = loss_and_grads(model, state["params"], tb, "float32",
                                    mesh=mesh)
    assert float(loss) == float(want_loss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    devices = [list(rm.devices) for rm in state.sharding.replicas]
    stripes, _ = reduce_grads(grads, state.specs, "float32", devices)
    got = state_to_arrays(_logical(stripes, state.specs))
    for path, w in state_to_arrays(want).items():
        w = w.astype(np.float64)
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (path, err)


def _fresh(model):
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _step_fn(model, mesh):
    return make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=3e-3, warmup_steps=1, decay_steps=20)), mesh=mesh)


def _train(key: str, shape=(2, 2), steps: int = 3):
    """``steps`` steps at ``shape`` from seed 0 (bf16 activations and
    casts)."""
    model = Model(configs_of(key, "bfloat16")[1])
    mesh = _mesh(*shape)
    state = shd.TrainSharding(mesh, model.cfg).place(_fresh(model))
    ds = make_dataset(model.cfg, 4, 32)
    step = _step_fn(model, mesh)
    losses = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        losses.append(float(met["loss"]))
    return model, state, ds, step, losses


@pytest.mark.parametrize("key", ARCHS)
def test_replicated_leaves_bit_equal_and_split_leaves_halved(key):
    """After 3 steps at (2 × 2): every replica's shard m equals replica
    0's, a leaf the ``model`` shards replicate equals its first shard's
    copy bit for bit, and a split leaf holds half its logical bytes."""
    _, state, _, _, losses = _train(key)
    assert all(np.isfinite(losses))
    logical = dict((p, (parts, leaf)) for p, parts, leaf in layer_parts(
        state.logical()["params"]))
    grid = state["params"]
    flat = [[list(layer_parts(t)) for t in rep] for rep in grid]
    n_split = n_rep = 0
    for i, (path, sparts, sleaf) in enumerate(layer_parts(state.specs)):
        split = (sparts[0] if sparts is not None else sleaf)[0] is not None
        n_split, n_rep = n_split + split, n_rep + (not split)
        lparts, lleaf = logical[path]
        for r, m in np.ndindex(len(grid), len(grid[0])):
            _, parts, leaf = flat[r][m][i]
            _, parts0, leaf0 = flat[0][m if split else 0][i]
            for t, t0, whole in zip(parts or [leaf], parts0 or [leaf0],
                                    lparts or [lleaf]):
                assert torch.equal(t, t0), (path, r, m)
                nbytes = t.numel() * t.element_size()
                assert nbytes * (2 if split else 1) == \
                    whole.numel() * whole.element_size(), (path, m)
    assert n_split and n_rep


def test_mesh_state_saves_reference_paths_and_restores_elsewhere(tmp_path):
    model, state, ds, step, _ = _train("hymba")
    save(str(tmp_path), 3, state)
    jcfg, _ = configs_of("hymba", "bfloat16")
    jm = build_model(jcfg)
    want = {p: tuple(a.shape) for p, a in jflatten(jax.eval_shape(
        lambda: jinit_state(jm, jax.random.PRNGKey(0))))}
    with np.load(tmp_path / "step_00000003.npz") as blob:
        got = {p: tuple(blob[p].shape) for p in blob.files}
    assert got == want
    other = shd.TrainSharding(_mesh(1, 4), model.cfg)
    back, at = restore(str(tmp_path), train_state_shapes(model),
                       shardings=other)
    assert at == 3 and isinstance(back, shd.MeshTrainState)
    mine = state_to_arrays(state.logical())
    for p, a in state_to_arrays(back.logical()).items():
        np.testing.assert_array_equal(a, mine[p], err_msg=p)
    b3 = ds.batch_at(3)
    _, here = step(state, b3)
    _, there = _step_fn(model, other.mesh)(back, b3)
    np.testing.assert_allclose(float(there["loss"]), float(here["loss"]),
                               rtol=2e-2)
