"""Training over a ``(data, model)`` mesh in the port, held against the
JAX package's unsharded step.

Tolerances (`tests/test_torch_train.py`'s, with their reasons there):
f32 activations and f32 gradient casts — loss rtol 2e-5; every gradient
leaf and both moments within 1e-4 of the leaf's largest magnitude; new
params within that plus the first Adam step's sign allowance; grad_norm
rtol 1e-5. bf16 activations and casts — the loss within 2e-2.

  * one step at (2 × 2), (2 × 1) and (1 × 2) from bridged reference
    params, Qwen2.5's smoke config and qwen2-moe's (experts split over
    ``model``, the dispatch grouped by data replica, the global aux);
  * replicas and every replicated leaf bit-equal after 3 steps, each
    replica's leaves their own storage;
  * ZeRO-1: each replica's moments are 1 / |data| of its stripe's;
  * checkpoints: a mesh state saves the reference's paths and shapes;
    `restore(shardings=)` puts it on another mesh, whose next step's
    loss is the first mesh's;
  * the launcher over ``--data-axis 2 --model-axis 2``, and mamba2 over
    ``--model-axis 2`` (its losses the unsharded launcher's);
  * `make_production_mesh` over 256 and 512 devices.
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
from repro.training.train_step import init_train_state as jinit_state
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import configs
from repro_torch.bridge import params_to_torch, state_to_arrays
from repro_torch.checkpoint import restore, save
from repro_torch.data.pipeline import make_dataset
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.optim import adamw_init
from repro_torch.training.train_step import (loss_and_grads, reduce_grads,
                                             train_state_shapes)
from repro_torch.utils.tree import layer_parts, map_tree

OPT = dict(lr=1e-3, warmup_steps=0, decay_steps=10, weight_decay=0.1)
ARCHS = ["qwen25-05b", "qwen2-moe-a2.7b"]
MESHES = [(2, 2), (2, 1), (1, 2)]


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


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The reference's unsharded f32 step: loss, gradients, new state."""
    arch = request.param
    cfg = dataclasses.replace(C.get_smoke_config(arch),
                              activation_dtype="float32")
    jm = build_model(cfg)
    jstate = jinit_state(jm, jax.random.PRNGKey(0))
    batch = jmake_dataset(cfg, 4, 32).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jstate["params"], jbatch)
    jnew, jmet = jax.jit(jmake_train_step(jm, JTrainConfig(
        optimizer=JAdamW(**OPT), grad_comm_dtype="float32")))(jstate, jbatch)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch),
                               activation_dtype="float32")
    return dict(model=Model(tcfg), jstate=jstate, batch=batch, jloss=jloss,
                jgrads=jgrads, jnew=jnew, jmet=jmet)


def _leaf_close(got: dict, want, bound: float = 1e-4):
    want = dict(jflatten(want))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[path], np.float64)
        assert g.shape == w.shape, path
        lim = bound * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= lim, (path, np.abs(g - w).max(), lim)


def _numel(jtree) -> int:
    return sum(int(np.prod(np.shape(a))) for _, a in jflatten(jtree))


def _count(tree) -> int:
    return sum(t.numel() for _, parts, leaf in layer_parts(tree)
               for t in (parts if parts is not None else [leaf]))


def _logical_grads(stripes, specs):
    return map_tree(lambda sp, *ts: shd.join_pieces(list(ts), sp[0], "cpu"),
                    specs, *stripes)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "2x1", "1x2"])
def test_sharded_step_matches_reference(ref, shape):
    model = ref["model"]
    mesh = _mesh(*shape)
    state = shd.TrainSharding(mesh, model.cfg).place(
        _port_state(ref["jstate"]))
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, _, grads = loss_and_grads(model, state["params"], batch,
                                    "float32", mesh=mesh)
    devices = [list(rm.devices) for rm in state.sharding.replicas]
    stripes, wire = reduce_grads(grads, state.specs, "float32", devices)
    np.testing.assert_allclose(float(loss), float(ref["jloss"]), rtol=2e-5)
    _leaf_close(state_to_arrays(_logical_grads(stripes, state.specs)),
                ref["jgrads"])
    # each replica sends every logical element once (a replicated leaf's
    # one gradient, each stripe), 4 bytes in f32
    n_el = _numel(ref["jstate"]["params"])
    assert wire == (shape[0] * 4 * n_el if shape[0] > 1 else 0)

    new, met = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**OPT), grad_comm_dtype="float32"),
        mesh=mesh)(state, ref["batch"])
    np.testing.assert_allclose(float(met["loss"]), float(ref["jloss"]),
                               rtol=2e-5)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(ref["jmet"][k]),
                                   rtol=1e-5)
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
    assert int(logical["step"]) == 1


def test_bf16_sharded_loss_close_to_reference():
    cfg = C.get_smoke_config("qwen25-05b")
    jm = build_model(cfg)
    jstate = jinit_state(jm, jax.random.PRNGKey(0))
    batch = jmake_dataset(cfg, 4, 32).batch_at(1)

    def jloss(p, b):
        p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                         if a.dtype == jnp.float32 and a.ndim >= 2 else a, p)
        return jm.loss(p, b)[0]
    want = float(jax.jit(jloss)(jstate["params"], {
        k: jnp.asarray(v) for k, v in batch.items()}))
    model = Model(configs.get_smoke_config("qwen25-05b"))
    mesh = _mesh(2, 2)
    state = shd.TrainSharding(mesh, model.cfg).place(_port_state(jstate))
    _, met = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(**OPT), grad_comm_dtype="bfloat16"),
        mesh=mesh)(state, batch)
    assert abs(float(met["loss"]) - want) <= 2e-2 * abs(want)
    assert met["wire_bytes"] == 2 * 2 * _numel(jstate["params"])


def _fresh(model):
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _step_fn(model, mesh):
    return make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=3e-3, warmup_steps=1, decay_steps=20)), mesh=mesh)


@pytest.fixture(scope="module", params=ARCHS)
def trained(request):
    """3 steps at (2 × 2) from seed 0 (bf16 activations and casts)."""
    arch = request.param
    model = Model(configs.get_smoke_config(arch))
    mesh = _mesh(2, 2)
    sharding = shd.TrainSharding(mesh, model.cfg)
    state = sharding.place(_fresh(model))
    ds = make_dataset(model.cfg, 4, 16)
    step = _step_fn(model, mesh)
    losses = []
    for i in range(3):
        state, met = step(state, ds.batch_at(i))
        losses.append(float(met["loss"]))
    return dict(arch=arch, model=model, sharding=sharding, state=state,
                ds=ds, step=step, losses=losses)


def test_replicas_and_replicated_leaves_bit_equal_after_steps(trained):
    """Every replica's shard m equals replica 0's bit for bit, a leaf the
    ``model`` shards replicate equals its first shard's copy, and every
    one of these tensors has storage of its own."""
    state = trained["state"]
    assert all(np.isfinite(trained["losses"]))
    grid = state["params"]
    flat = [[list(layer_parts(t)) for t in rep] for rep in grid]
    ptrs, n = set(), 0
    for i, (path, sparts, sleaf) in enumerate(layer_parts(state.specs)):
        split = (sparts[0] if sparts is not None else sleaf)[0] is not None
        for r, m in np.ndindex(len(grid), len(grid[0])):
            _, parts, leaf = flat[r][m][i]
            _, parts0, leaf0 = flat[0][m if split else 0][i]
            for t, t0 in zip(parts or [leaf], parts0 or [leaf0]):
                assert torch.equal(t, t0), (path, r, m)
                ptrs.add(t.untyped_storage().data_ptr())
                n += 1
    assert len(ptrs) == n


def test_zero1_slices_halve_each_replicas_moments(trained):
    """Replica r's moment of a leaf is its stripe cut in two along the
    leaf's ZeRO-1 dim (slice r); the slices join to the logical moment;
    each replica holds half of the moments' elements."""
    state = trained["state"]
    logical = state.logical()

    def check(sp, whole, piece, m):
        if sp[0] is None and m:     # a replicated leaf: on shard 0 only
            assert piece is None
            return
        want = list(whole.shape)
        for d in sp:
            if d is not None:
                want[d] //= 2
        assert list(piece.shape) == want
    for key in ("m", "v"):
        for r in range(2):
            for m in range(2):
                map_tree(lambda sp, w, p, _m=m: check(sp, w, p, _m),
                         state.specs, logical["opt"][key],
                         state["opt"][key][r][m])
    mine = sum(_count(state["opt"]["m"][0][m]) for m in range(2))
    whole = _count(logical["opt"]["m"])
    assert whole == _count(logical["params"])
    assert 2 * mine <= whole * 1.01


def test_mesh_checkpoint_saves_reference_paths_and_restores_elsewhere(
        trained, tmp_path):
    model, state = trained["model"], trained["state"]
    save(str(tmp_path), 3, state)
    jm = build_model(C.get_smoke_config(trained["arch"]))
    want = {p: tuple(a.shape) for p, a in jflatten(jax.eval_shape(
        lambda: jinit_state(jm, jax.random.PRNGKey(0))))}
    with np.load(tmp_path / "step_00000003.npz") as blob:
        got = {p: tuple(blob[p].shape) for p in blob.files}
    assert got == want
    other = shd.TrainSharding(_mesh(1, 2), model.cfg)
    back, step = restore(str(tmp_path), train_state_shapes(model),
                         shardings=other)
    assert step == 3 and isinstance(back, shd.MeshTrainState)
    mine = state_to_arrays(state.logical())
    for p, a in state_to_arrays(back.logical()).items():
        np.testing.assert_array_equal(a, mine[p], err_msg=p)
    b3 = trained["ds"].batch_at(3)
    _, here = trained["step"](state, b3)
    _, there = _step_fn(model, other.mesh)(back, b3)
    np.testing.assert_allclose(float(there["loss"]), float(here["loss"]),
                               rtol=2e-2)


def test_launcher_over_a_mesh_and_its_refusal():
    from repro_torch.launch.train import main
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "16", "--log-every", "100"]
    plain = main(args)
    meshed = main(args + ["--data-axis", "2", "--model-axis", "2"])
    assert meshed["steps"] == 3 and all(np.isfinite(meshed["losses"]))
    np.testing.assert_allclose(meshed["losses"], plain["losses"], rtol=2e-2)
    ssm = ["--smoke", "--device", "cpu", "--arch", "mamba2-130m",
           "--steps", "2", "--batch", "4", "--seq", "16", "--log-every",
           "100"]
    split = main(ssm + ["--model-axis", "2"])
    assert split["steps"] == 2 and all(np.isfinite(split["losses"]))
    np.testing.assert_allclose(split["losses"], main(ssm)["losses"],
                               rtol=2e-2)
    with pytest.raises(ValueError, match="does not split"):
        main(args + ["--data-axis", "3"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_device_lists(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = int(np.prod(shape))
    for have in (256, 512):
        # 100 distinct device indices, then the CPU: the prefix is kept
        devices = [f"cuda:{i}" for i in range(100)] + ["cpu"] * (have - 100)
        if have < n:
            with pytest.raises(RuntimeError, match="needs 512 devices"):
                make_production_mesh(multi_pod, devices=devices)
            continue
        mesh = make_production_mesh(multi_pod, devices=devices)
        assert mesh.devices.shape == shape
        assert mesh.axis_names == (("pod",) if multi_pod else ()) \
            + ("data", "model")
        assert list(mesh.devices.flat) == [torch.device(d)
                                           for d in devices[:n]]
        assert shd.dp_size(mesh) == n // 16
        reps = shd.replica_meshes(mesh)
        assert len(reps) == n // 16 and reps[1].devices[0] == \
            torch.device("cuda", 16)
