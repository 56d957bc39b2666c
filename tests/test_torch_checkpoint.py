"""Checkpointing on the port: atomic save / restore, the async writer, GC,
exact resume and the launcher's failure recovery (the reference's
`tests/test_checkpoint.py`, each test on the port), and the file format
across the packages: a checkpoint written by either restores in the
other bit for bit, and both write the same npz keys, shapes and dtypes.
Every comparison here is exact (bit for bit): nothing is recomputed.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.models import build_model
from repro.training.train_step import init_train_state as jinit_state
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import configs
from repro_torch.bridge import params_to_torch, state_to_arrays
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.core.pipeline import quantize_params
from repro_torch.data.pipeline import make_dataset
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.optim import adamw_init
from repro_torch.training.train_step import (init_train_state,
                                             train_state_shapes)
from repro_torch.utils.tree import flatten_with_paths


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and a train step's many small ops otherwise spin
    on oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's initial train state (numpy leaves) and its model."""
    jm = build_model(C.get_smoke_config("qwen25-05b"))
    return jm, jinit_state(jm, jax.random.PRNGKey(0))


@pytest.fixture
def state_and_step(ref_state):
    _, jstate = ref_state
    model = Model(configs.get_smoke_config("qwen25-05b"))
    params = params_to_torch(jax.tree.map(np.asarray, jstate["params"]),
                             device="cpu")
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=1, decay_steps=10, weight_decay=0.0)))
    ds = make_dataset(model.cfg, 4, 32)
    return model, state, step, ds


def _assert_same(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


def test_save_restore_exact(tmp_path, state_and_step):
    model, state, _, _ = state_and_step
    save(str(tmp_path), 3, state)
    state2, got = restore(str(tmp_path), train_state_shapes(model),
                          device="cpu")
    assert got == 3
    _assert_same(state, state2)


def test_resume_is_bitexact(tmp_path, state_and_step):
    model, state, step, ds = state_and_step
    for i in range(3):
        state, _ = step(state, ds.batch_at(i))
    save(str(tmp_path), 3, state)
    state2, _ = restore(str(tmp_path), train_state_shapes(model),
                        device="cpu")
    _, m1 = step(state, ds.batch_at(3))
    _, m2 = step(state2, ds.batch_at(3))
    assert float(m1["loss"]) == float(m2["loss"])


def test_latest_pointer_written_after_data(tmp_path, state_and_step):
    _, state, _, _ = state_and_step
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    assert os.path.exists(tmp_path / "step_00000007.npz")


def test_async_checkpointer_and_gc(tmp_path, state_and_step):
    _, state, _, _ = state_and_step
    ac = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ac.save(s, state)
    ac.close()
    assert latest_step(str(tmp_path)) == 4
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["step_00000003.npz", "step_00000004.npz"]


def test_async_checkpointer_raises_worker_errors_on_wait(tmp_path,
                                                         state_and_step):
    _, state, _, _ = state_and_step
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = AsyncCheckpointer(str(blocker / "ck"))
    ac.save(1, state)
    with pytest.raises(OSError):
        ac.wait()


def test_restore_quantized_params(tmp_path):
    """PackedLinear trees round-trip through the checkpoint format."""
    model = Model(configs.get_smoke_config("qwen25-05b"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    qp, _ = quantize_params(params)
    save(str(tmp_path), 0, qp)
    qp2, _ = restore(str(tmp_path), qp, device="cpu")
    _assert_same(qp, qp2)


def test_train_launcher_failure_recovery(tmp_path):
    """End-to-end node-failure path through the launcher."""
    from repro_torch.launch.train import main
    out = main(["--arch", "qwen25-05b", "--smoke", "--device", "cpu",
                "--steps", "12", "--batch", "4", "--seq", "32", "--ckpt-dir",
                str(tmp_path / "ck"), "--ckpt-every", "5",
                "--simulate-failure-at", "7", "--lr", "1e-3"])
    assert out["steps"] >= 12 - 5  # recovered and finished
    assert out["recoveries"] == 1
    assert latest_step(str(tmp_path / "ck")) == 12


def test_launcher_and_restore_refuse_meshes(tmp_path, state_and_step):
    """The launcher over a mesh: a model axis above 1 for mamba2 (its
    SSD split over ``model``) and a data axis train, and
    `restore(shardings=)` splits a checkpoint onto a mesh whose logical
    state is the file's."""
    from repro_torch.distributed.sharding import MeshTrainState, TrainSharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import main
    ssm = main(["--smoke", "--device", "cpu", "--arch", "mamba2-130m",
                "--model-axis", "2", "--steps", "1", "--batch", "4",
                "--seq", "16"])
    assert ssm["steps"] == 1 and np.isfinite(ssm["first_loss"])
    out = main(["--smoke", "--device", "cpu", "--data-axis", "2",
                "--steps", "2", "--batch", "4", "--seq", "16"])
    assert out["steps"] == 2
    model, state, _, _ = state_and_step
    save(str(tmp_path), 1, state)
    sharding = TrainSharding(make_host_mesh(2, 1, devices=["cpu"] * 2),
                             model.cfg)
    placed, _ = restore(str(tmp_path), train_state_shapes(model),
                        device="cpu", shardings=sharding)
    assert isinstance(placed, MeshTrainState)
    want = state_to_arrays(state)
    got = state_to_arrays(placed.logical())
    assert list(got) == list(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_reference_checkpoint_restores_in_the_port(tmp_path, ref_state):
    _, jstate = ref_state
    jsave(str(tmp_path), 5, jstate)
    model = Model(configs.get_smoke_config("qwen25-05b"))
    state, step = restore(str(tmp_path), train_state_shapes(model),
                          device="cpu")
    assert step == 5
    got = state_to_arrays(state)
    want = jflatten(jstate)
    assert list(got) == [p for p, _ in want]
    for path, w in want:
        w = np.asarray(w)
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_port_checkpoint_restores_in_the_reference(tmp_path, ref_state,
                                                   state_and_step):
    jm, jstate = ref_state
    _, state, step_fn, ds = state_and_step
    state, _ = step_fn(state, ds.batch_at(0))      # moments, step 1
    save(str(tmp_path), 1, state)
    tpl = jax.eval_shape(lambda: jinit_state(jm, jax.random.PRNGKey(0)))
    jgot, step = jrestore(str(tmp_path), tpl)
    assert step == 1
    arrays = state_to_arrays(state)
    for path, leaf in jflatten(jgot):
        leaf = np.asarray(leaf)
        assert leaf.dtype == arrays[path].dtype, path
        np.testing.assert_array_equal(leaf, arrays[path], err_msg=path)


def test_npz_keys_shapes_dtypes_equal(tmp_path, ref_state, state_and_step):
    _, jstate = ref_state
    _, state, _, _ = state_and_step
    jpath = jsave(str(tmp_path / "ref"), 0, jstate)
    path = save(str(tmp_path / "port"), 0, state)
    with np.load(jpath) as a, np.load(path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_recovery_waits_for_the_save_in_flight(tmp_path, monkeypatch):
    """A failure while step 4's checkpoint is still being written resumes
    from step 4 (the launcher waits for the writer first), not from
    step 0, and the redone step repeats its loss bit for bit. The write
    is slowed down here as a 5.9 GB checkpoint is on the card."""
    import time

    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch.train import main
    write = checkpointer._write

    def slow_write(*a):
        time.sleep(0.5)
        return write(*a)
    monkeypatch.setattr(checkpointer, "_write", slow_write)
    out = main(["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
                "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                "--ckpt-every", "4", "--simulate-failure-at", "5"])
    assert out["recoveries"] == 1
    assert out["steps"] == 5 + 2            # steps 0-4, then 4-5 again
    assert out["losses"][5] == out["losses"][4]
    assert latest_step(str(tmp_path / "ck")) == 6


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "mamba2-130m",
                                  "hubert-xlarge"])
def test_family_train_state_restores_in_the_reference(tmp_path, name):
    """A port train state of the MoE family (stacked experts, routers),
    the SSM (its own leaves: conv taps, ``a_log``, ``dt_bias``) and the
    encoder (``frontend/frame_proj``, an untied ``lm_head``, a table no
    batch reads), after one step (moments set), saved by the port: the
    reference's `restore` reads it, leaf for leaf equal, in the
    reference's leaf order; the port reads it back equal too."""
    cfg = configs.get_smoke_config(name)
    model = Model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=1, decay_steps=10, weight_decay=0.1)))
    state, _ = step(state, make_dataset(cfg, 2, 32).batch_at(0))
    save(str(tmp_path), 1, state)
    jm = build_model(C.get_smoke_config(name))
    tpl = jax.eval_shape(lambda: jinit_state(jm, jax.random.PRNGKey(0)))
    jgot, got_step = jrestore(str(tmp_path), tpl)
    assert got_step == 1
    arrays = state_to_arrays(state)
    flat = jflatten(jgot)
    assert [p for p, _ in flat] == list(arrays)
    for path, leaf in flat:
        leaf = np.asarray(leaf)
        assert leaf.dtype == arrays[path].dtype, path
        np.testing.assert_array_equal(leaf, arrays[path], err_msg=path)
    want = {"qwen2-moe-a2.7b": "params/segments/seg_0/moe/experts/gate/w",
            "mamba2-130m": "params/segments/seg_0/ssm/a_log",
            "hubert-xlarge": "params/frontend/frame_proj/w"}[name]
    assert want in arrays
    back, _ = restore(str(tmp_path), train_state_shapes(model),
                      device="cpu")
    _assert_same(state, back)


def test_launcher_recovery_redoes_deepseek_losses_bit_for_bit(tmp_path):
    """The launcher on deepseek's smoke config (MLA, a dense first layer,
    MoE layers): a failure injected at step 6 reloads step 4's checkpoint,
    and the redone steps 4 and 5 give the first run's losses bit for
    bit."""
    from repro_torch.launch.train import main
    out = main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
                "cpu", "--steps", "8", "--batch", "2", "--seq", "32",
                "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4",
                "--simulate-failure-at", "6", "--lr", "1e-3"])
    losses = out["losses"]
    assert out["recoveries"] == 1 and len(losses) == 10
    assert latest_step(str(tmp_path / "ck")) == 8
    assert losses[6:8] == losses[4:6]
    assert all(np.isfinite(losses))
