"""Port parity: the calibration forward — capture names and statistics,
`Model.loss`, the synthetic dataset, and train/prefill `attention()`
(through K4's plain version) — against the JAX package.

Qwen2.5's smoke config with its real grouping (14 q heads over 2 kv
heads, G = 7), bridged weights, the launcher's calibration batch.
Tolerances: under f32 activations rtol/atol 1e-4 for captured rows and
the loss (the two frameworks sum the same f32 products in another order,
~1e-6 after a few layers), and `attention()` at the reference's f32
kernel tolerance rtol 2e-5; under bf16 activations the reference's bf16
tolerance 2e-2 — the port's K4 keeps attention probabilities in f32
where the reference's `_sdpa` rounds them to bf16, and a value rounded
to a neighbouring bf16 step (2^-8 relative) moves later layers, so a
single captured element may drift by several bf16 steps: captured rows
are held as a whole, at 2e-2 relative Frobenius error (measured up to
1.3e-2 on this config), and their per-channel means at 2e-2.
The dataset must be bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen25_05b as jcfgs
from repro.core import calibration as jcal
from repro.data import make_dataset as jmake
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import qwen25_05b as tcfgs
from repro_torch.core import calibration as tcal
from repro_torch.core.packing import PackedLinear
from repro_torch.core.pipeline import quantize_params
from repro_torch.data.pipeline import make_dataset as tmake
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _cfgs(adt):
    kw = dict(num_heads=14, num_kv_heads=2, activation_dtype=adt)
    return (dataclasses.replace(jcfgs.smoke_config(), **kw),
            dataclasses.replace(tcfgs.smoke_config(), **kw))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def calibrated(request):
    """(activation dtype, JAX stats, port stats, JAX loss, port loss)."""
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = jbuild(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    batch = jmake(jcfg, 2, 64, seed=123).batch_at(0)
    with jcal.CalibrationCapture() as jcap:
        jloss, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with tcal.CalibrationCapture() as tcap, torch.no_grad():
        tloss, aux = tm.loss(tp, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert float(aux["tokens"]) == 2 * 64
    return request.param, jcap.stats, tcap.stats, float(jloss), float(tloss)


def test_capture_names_equal_the_references(calibrated):
    _, jstats, tstats, _, _ = calibrated
    assert sorted(tstats) == sorted(jstats)
    assert "segments/seg_0/attn/wq@1" in tstats
    assert len(tstats) == 7 * 2          # 7 linears x 2 layers


def test_capture_stats_are_close(calibrated):
    adt, jstats, tstats, _, _ = calibrated
    for name, js in jstats.items():
        ts = tstats[name]
        assert ts.count == js.count
        assert ts.rows.shape == js.rows.shape and ts.rows.dtype == np.float32
        if adt == "float32":
            np.testing.assert_allclose(ts.rows, js.rows, **TOL[adt])
            np.testing.assert_allclose(ts.act_mean, js.act_mean, **TOL[adt])
        else:
            err = np.linalg.norm(ts.rows - js.rows) / np.linalg.norm(js.rows)
            assert err <= 2e-2, (name, err)
            np.testing.assert_allclose(ts.act_mean, js.act_mean, **TOL[adt])


def test_loss_is_close(calibrated):
    adt, _, _, jloss, tloss = calibrated
    np.testing.assert_allclose(tloss, jloss, **TOL[adt])


def test_loss_ignores_negative_labels_and_chunks_the_vocab():
    """Labels < 0 are left out of the mean; the loss does not depend on
    how many positions each vocab chunk covers."""
    _, tcfg = _cfgs("float32")
    m = Model(tcfg)
    p = m.init(torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in tmake(tcfg, 2, 64, seed=5).batch_at(0).items()}
    full, aux = m.loss(p, batch)
    m8 = Model(dataclasses.replace(tcfg, logits_chunk=8))
    np.testing.assert_allclose(float(m8.loss(p, batch)[0]), float(full),
                               rtol=1e-6)
    masked = dict(batch, labels=batch["labels"].clone())
    masked["labels"][:, 32:] = -1
    half, aux_h = m.loss(p, masked)
    assert float(aux_h["tokens"]) == 64 and float(aux["tokens"]) == 128
    first = {k: v[:, :32] for k, v in batch.items()}
    # the first halves alone: same CE as the masked run (causal model)
    np.testing.assert_allclose(float(half), float(m.loss(p, first)[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("step,batch,seq,seed", [(0, 2, 64, 123),
                                                 (3, 4, 32, 0),
                                                 (7, 1, 17, 5)])
def test_dataset_batches_are_bit_equal(step, batch, seq, seed):
    _, tcfg = _cfgs("float32")
    jcfg, _ = _cfgs("float32")
    jb = jmake(jcfg, batch, seq, seed=seed).batch_at(step)
    tb = tmake(tcfg, batch, seq, seed=seed).batch_at(step)
    assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
    for k in jb:
        assert jb[k].dtype == tb[k].dtype
        np.testing.assert_array_equal(jb[k], tb[k])


# s, window, attn_chunk: the reference chunks queries when S > attn_chunk
# and S divides by it (the first two); the port sends all to K4
ATTN_CASES = [(64, 0, 16), (64, 24, 32), (40, 0, 32), (50, 7, 1024)]


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,chunk", ATTN_CASES)
def test_attention_matches_jax(adt, s, window, chunk):
    jcfg, tcfg = _cfgs(adt)
    jcfg = dataclasses.replace(jcfg, attn_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, attn_chunk=chunk)
    jp = jattn.attn_init(jax.random.PRNGKey(s + window), jcfg)
    tp = bridge.tree_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    x = np.random.default_rng(s).standard_normal((2, s, jcfg.d_model))
    jx = jnp.asarray(x, jnp.dtype(adt))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s))
    jy = jattn.attention(jp, jx, jcfg, positions=jnp.asarray(pos),
                         window=window)
    ty = tattn.attention(tp, bridge.to_tensor(np.asarray(jx), "cpu"), tcfg,
                         positions=torch.from_numpy(pos.copy()),
                         window=window)
    assert ty.dtype == bridge.to_tensor(np.asarray(jy), "cpu").dtype
    tol = (dict(rtol=2e-5, atol=2e-5) if adt == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), **tol)


def test_capture_records_float_linears_only():
    """No capture outside the context; nesting raises; quantized linears
    (already calibrated) record nothing; rows stop at ``max_rows``."""
    tcfg = tcfgs.smoke_config()         # 2 q / 1 kv heads: wk, wv stay float
    m = Model(tcfg)
    p = m.init(torch.Generator().manual_seed(2), device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in tmake(tcfg, 2, 32, seed=1).batch_at(0).items()}
    assert not tcal.capture_active()
    tcal.record_linear_input("x", torch.ones(2, 3))       # idle: no-op
    with tcal.CalibrationCapture(max_rows=40) as cap, torch.no_grad():
        with pytest.raises(RuntimeError):
            tcal.CalibrationCapture().__enter__()
        m.loss(p, batch)
        m.loss(p, batch)
    assert not tcal.capture_active()
    st = cap.stats["segments/seg_0/mlp/down@1"]
    assert st.rows.shape == (40, tcfg.d_ff) and st.count == 2 * 64
    qp, _ = quantize_params(p)
    assert isinstance(qp["segments"]["seg_0"][0]["attn"]["wq"], PackedLinear)
    with tcal.CalibrationCapture() as cap2, torch.no_grad():
        m.loss(qp, batch)
    # wk / wv stay float at this width (K·N < 16384): only they record
    assert sorted(cap2.stats) == sorted(f"segments/seg_0/attn/{w}@{i}"
                                        for i in (0, 1) for w in ("wk", "wv"))
