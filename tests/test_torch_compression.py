"""int8 + error-feedback gradient compression in the port, held against
the JAX package's `distributed/compression.py` and
`training/dp_compressed.py`.

  * `quantize_ef` — the reference's unit properties on both packages'
    functions (codes within ±127, residual within scale / 2, the mean of
    repeated sends converging on the gradient) and the port's codes and
    residuals equal to the reference's on the same inputs;
  * `make_dp_train_step` — one subprocess runs the reference's step with
    4 forced host devices (its own test's pattern; f32 activations on
    both sides, so that the codes can agree) for 3 steps an arm,
    and writes the codes each step sends (each shard's gradient plus
    residual at the shared scale, through the reference's `quantize_ef`);
    and the state (params, residuals) before each step; the port's step,
    from the same params and batches on a 4-shard ``data`` mesh: the f32
    arm's losses at rtol 2e-5 (the same math, sums in another order); the
    int8 arm's losses at 1e-4 relative, and the codes the port forms from
    the reference's state before each step (bridged, the residuals
    through `bridge.ef_to_torch`) equal in at least 99.9 % of elements
    and off by one elsewhere (a gradient element within rounding of a
    code boundary).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.distributed.compression import quantize_ef as jquantize_ef
from repro.models import build_model
from repro_torch import bridge, configs
from repro_torch.bridge import state_to_arrays
from repro_torch.data.pipeline import make_dataset
from repro_torch.distributed.compression import (init_ef, int8_psum_mean,
                                                 quantize_ef)
from repro_torch.distributed.sharding import Mesh, split_batch
from repro_torch.models.model import Model
from repro_torch.training.dp_compressed import (dp_degree, init_dp_state,
                                                make_dp_train_step)
from repro_torch.training.optim import AdamWConfig, adamw_init
from repro_torch.training.train_step import loss_and_grads

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_quantize_ef_residual_bound_and_reference_codes():
    g = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    ef = np.random.default_rng(1).standard_normal(256).astype(np.float32) \
        * 0.01
    scale = np.float32(np.abs(g + ef).max() / 127.0)
    q, ef1 = quantize_ef(torch.from_numpy(g), torch.from_numpy(ef),
                         torch.tensor(scale))
    jq, jef1 = jquantize_ef(jnp.asarray(g), jnp.asarray(ef),
                            jnp.asarray(scale))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert float(ef1.abs().max()) <= float(scale) / 2 + 1e-7
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ef1.numpy(), np.asarray(jef1), rtol=0,
                               atol=1e-7)


def test_error_feedback_accumulates_unbiased():
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(128)
                         .astype(np.float32) * 1e-3)
    scale = torch.tensor(0.01)
    ef = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    n = 50
    for _ in range(n):
        q, ef = quantize_ef(g, ef, scale)
        sent += q.to(torch.float32) * scale
    np.testing.assert_allclose((sent / n).numpy(), g.numpy(),
                               atol=float(scale) / 2 / n + 1e-6)


def test_int8_psum_mean_is_the_shared_scale_mean():
    rng = np.random.default_rng(2)
    gs = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
          for _ in range(4)]
    efs = init_ef(gs)
    mean, new, scale, wire = int8_psum_mean([[g[:40], g[40:]] for g in gs],
                                            [[e[:40], e[40:]] for e in efs],
                                            ["cpu"] * 4)
    x = torch.stack(gs)
    assert float(scale) == float(x.abs().max() / 127.0)
    qs = [quantize_ef(g, e, scale)[0] for g, e in zip(gs, efs)]
    want = sum(q.to(torch.int32) for q in qs).to(torch.float32) * scale / 4
    assert torch.equal(torch.cat(mean), want)
    assert wire == 4 * (64 + 4)
    assert all(float(torch.cat(e).abs().max()) <= float(scale) / 2 + 1e-7
               for e in new)


SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.configs as C
from repro.models import build_model
from repro.data import make_dataset
from repro.distributed.compression import quantize_ef
from repro.training.optim import AdamWConfig
from repro.training.dp_compressed import init_dp_state, make_dp_train_step
from repro.utils.tree import flatten_with_paths

steps, out_path = int(sys.argv[1]), sys.argv[2]
import dataclasses
cfg = dataclasses.replace(C.get_smoke_config("qwen25-05b"),
                          activation_dtype="float32")
m = build_model(cfg)
mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("data",))
opt = AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=60, weight_decay=0.0)
ds = make_dataset(cfg, 8, 64)
grad = jax.jit(jax.grad(lambda p, b: m.loss(p, b)[0]))
res, codes = {}, {}
for compress in (False, True):
    state, ef = init_dp_state(m, jax.random.PRNGKey(0), mesh)
    step = make_dp_train_step(m, mesh, opt, compress=compress)
    losses = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        if compress:
            gs = [grad(state["params"], {k: v[2 * d:2 * d + 2]
                                         for k, v in batch.items()})
                  for d in range(4)]
            flat = [dict(flatten_with_paths(gd)) for gd in gs]
            for path, a in flatten_with_paths(state["params"]):
                codes[f"p{i}/{path}"] = np.asarray(a)
            for path, e in flatten_with_paths(ef):
                codes[f"e{i}/{path}"] = np.asarray(e)
                g = [f[path] for f in flat]
                amax = max(float(jnp.max(jnp.abs(gd + e[d])))
                           for d, gd in enumerate(g))
                scale = jnp.asarray(1.0 if amax == 0 else amax / 127.0,
                                    jnp.float32)
                codes[f"q{i}/{path}"] = np.stack([np.asarray(quantize_ef(
                    gd, e[d], scale)[0]) for d, gd in enumerate(g)])
        state, ef, metrics = step(state, ef, batch)
        losses.append(float(metrics["loss"]))
    res["int8" if compress else "f32"] = losses
np.savez(out_path, **codes)
print("RESULT:" + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp") / "codes.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(STEPS),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT:")]
    assert line, proc.stdout
    with np.load(out) as blob:
        codes = {k: blob[k] for k in blob.files}
    return json.loads(line[0][len("RESULT:"):]), codes


def _cfg():
    return dataclasses.replace(configs.get_smoke_config("qwen25-05b"),
                               activation_dtype="float32")


def _port_run(compress: bool):
    """The port's step for ``STEPS`` steps from the reference's init."""
    model = Model(_cfg())
    mesh = Mesh(["cpu"] * 4, ("data",))
    jparams = build_model(dataclasses.replace(
        C.get_smoke_config("qwen25-05b"), activation_dtype="float32")).init(
        jax.random.PRNGKey(0))
    params = bridge.params_to_torch(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    _, ef = init_dp_state(model, torch.Generator().manual_seed(0), mesh,
                          device="cpu")
    assert dp_degree(mesh) == 4
    step = make_dp_train_step(model, mesh, AdamWConfig(
        lr=3e-3, warmup_steps=2, decay_steps=60, weight_decay=0.0),
        compress=compress)
    ds = make_dataset(model.cfg, 8, 64)
    losses, metrics = [], []
    for i in range(STEPS):
        state, ef, met = step(state, ef, ds.batch_at(i))
        losses.append(float(met["loss"]))
        metrics.append(met)
    return model, mesh, ds, state, ef, losses, metrics


def _port_codes(model, mesh, ds, ef_template, ref: dict, i: int) -> dict:
    """The codes step ``i`` sends, formed by the port from the reference's
    params and residuals before that step (`bridge.arrays_to_state`,
    `bridge.ef_to_torch`): each shard's gradient plus residual at the
    shared scale."""
    params = bridge.arrays_to_state(
        {k[len(f"p{i}/"):]: v for k, v in ref.items()
         if k.startswith(f"p{i}/")},
        model.init(torch.Generator().manual_seed(0), device="meta"), "cpu")
    ef = bridge.ef_to_torch({k[len(f"e{i}/"):]: v for k, v in ref.items()
                             if k.startswith(f"e{i}/")}, ef_template, "cpu")
    gs = [state_to_arrays(loss_and_grads(model, params, b, "float32")[2])
          for b in split_batch(ds.batch_at(i), mesh)]
    out = {}
    for path, e in bridge.ef_to_arrays(ef).items():
        g = [gd[path] for gd in gs]
        amax = max(float(np.abs(gd + e[d]).max()) for d, gd in enumerate(g))
        scale = torch.tensor(1.0 if amax == 0 else amax / 127.0,
                             dtype=torch.float32)
        out[f"q{i}/{path}"] = np.stack([quantize_ef(
            torch.from_numpy(gd), torch.from_numpy(e[d]), scale)[0].numpy()
            for d, gd in enumerate(g)])
    return out


def test_f32_arm_matches_reference(reference_run):
    res, _ = reference_run
    *_, losses, metrics = _port_run(False)
    np.testing.assert_allclose(losses, res["f32"], rtol=2e-5)
    assert metrics[0]["wire_bytes"] > 0


def test_int8_arm_matches_reference_losses_and_codes(reference_run):
    res, ref = reference_run
    model, mesh, ds, _, ef, losses, metrics = _port_run(True)
    np.testing.assert_allclose(losses, res["int8"], rtol=1e-4)
    got = {}
    for i in range(STEPS):
        got.update(_port_codes(model, mesh, ds, ef, ref, i))
    want = {k: v for k, v in ref.items() if k.startswith("q")}
    assert set(got) == set(want)
    total = equal = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.int8 and g.shape == w.shape, k
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1, k
        total += diff.size
        equal += int((diff == 0).sum())
    assert equal >= 0.999 * total, (equal, total)
    # the wire: one int8 code an element and one f32 scale a tensor, a
    # shard; every residual within half its tensor's scale, not all zero
    arrays = bridge.ef_to_arrays(ef)
    n_el = sum(a[0].size for a in arrays.values())
    assert metrics[-1]["wire_bytes"] == 4 * (n_el + 4 * len(arrays))
    assert 0 < float(metrics[-1]["ef_over_scale"]) <= 0.5 + 1e-6
    assert any(np.abs(a).max() > 0 for a in arrays.values())
    assert all(a.shape[0] == 4 for a in arrays.values())
