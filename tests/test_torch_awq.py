"""Port parity: the AWQ scale search, `fold_into_norm` and calibrated
`quantize_params` against the JAX package, on the same captured rows.

The search is fed identical activation rows and weights on both sides
(numpy from a seed, or the JAX capture of the smoke model's calibration
forward). Tie rule: the 20 candidate losses can lie within float noise
of each other, and XLA and PyTorch sum them in another order (measured
relative difference of a loss across frameworks ≤ 1e-6), so the port
must pick the JAX package's alpha index unless the JAX losses of the two
picks lie within ε = 1e-5 of each other, relatively. Where the picks
agree, the candidate scales agree to a few f32 ulps (`pow` differs in
the last bit between XLA and PyTorch; rtol 2e-6), the input scales and
the group scales derived from them at f32 tolerance (rtol 2e-5), and the
packed words and zeros must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen25_05b as jcfgs
from repro.core import awq as jawq
from repro.core import calibration as jcal
from repro.core import pipeline as jpipe
from repro.core.quantize import QuantConfig as JQuantConfig
from repro.data import make_dataset as jmake
from repro.models import build_model as jbuild
from repro_torch import bridge
from repro_torch.core import awq as tawq
from repro_torch.core import pipeline as tpipe
from repro_torch.core.packing import PackedLinear
from repro_torch.core.quantize import QuantConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


EPS_TIE = 1e-5
CAND = dict(rtol=2e-6, atol=0)


def _rows_and_weight(seed, rows, k, n):
    rng = np.random.default_rng(seed)
    # a few salient input channels, as real activations have
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[:, rng.integers(0, k, 4)] *= 20
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _jax_losses(x, w, cfg):
    jx = jnp.asarray(x)[: cfg.max_calib_rows]
    cands = jawq.activation_scale_candidates(
        jnp.mean(jnp.abs(jx), axis=0), jnp.asarray(w), cfg)
    losses = jax.vmap(lambda s: jawq._search_loss(jx, jnp.asarray(w), s,
                                                  cfg.quant))(cands)
    return np.asarray(cands), np.asarray(losses)


def _port_losses(x, w, cfg):
    tx = torch.from_numpy(x)[: cfg.max_calib_rows]
    cands = tawq.activation_scale_candidates(tx.abs().mean(0),
                                             torch.from_numpy(w), cfg)
    return cands.numpy(), tawq._search_loss(tx, torch.from_numpy(w), cands,
                                            cfg.quant).numpy()


def _assert_same_pick(j_losses, t_idx):
    j_idx = int(np.argmin(j_losses))
    if t_idx != j_idx:
        gap = abs(j_losses[t_idx] - j_losses[j_idx]) / j_losses[j_idx]
        assert gap <= EPS_TIE, (t_idx, j_idx, gap)
    return t_idx == j_idx


@pytest.mark.parametrize("duo", [True, False])
@pytest.mark.parametrize("seed,rows,k,n", [(0, 128, 128, 64),
                                           (1, 600, 256, 136),
                                           (2, 8, 64, 8)])
def test_candidates_and_losses_match_jax(seed, rows, k, n, duo):
    x, w = _rows_and_weight(seed, rows, k, n)
    jc = jawq.AWQConfig(duo_scaling=duo)
    tc = tawq.AWQConfig(duo_scaling=duo)
    j_cands, j_losses = _jax_losses(x, w, jc)
    t_cands, t_losses = _port_losses(x, w, tc)
    assert t_cands.shape == (20, k) and t_cands.dtype == np.float32
    np.testing.assert_allclose(t_cands, j_cands, **CAND)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    _assert_same_pick(j_losses, int(np.argmin(t_losses)))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_search_picks_the_references_scale(seed):
    x, w = _rows_and_weight(seed, 700, 192, 72)     # rows beyond 512 dropped
    js, jl = jawq.search_awq_scale(jnp.asarray(x), jnp.asarray(w),
                                   jawq.AWQConfig())
    ts, tl = tawq.search_awq_scale(x, torch.from_numpy(w), tawq.AWQConfig())
    _, j_losses = _jax_losses(x, w, jawq.AWQConfig())
    t_cands, _ = _port_losses(x, w, tawq.AWQConfig())
    t_idx = int(np.flatnonzero((t_cands == ts.numpy()).all(axis=1))[0])
    if _assert_same_pick(j_losses, t_idx):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **CAND)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_single_scale_loss_equals_its_grid_row():
    x, w = _rows_and_weight(6, 64, 128, 32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    cfg = tawq.AWQConfig()
    cands = tawq.activation_scale_candidates(tx.abs().mean(0), tw, cfg)
    grid = tawq._search_loss(tx, tw, cands, cfg.quant)
    for i in (0, 7, 19):
        np.testing.assert_allclose(
            float(tawq._search_loss(tx, tw, cands[i], cfg.quant)),
            float(grid[i]), rtol=1e-6)


def test_shared_scale_matches_jax():
    """One scale for q / k / v reading the same rows."""
    x, _ = _rows_and_weight(7, 256, 128, 8)
    rng = np.random.default_rng(8)
    ws = [(rng.standard_normal((128, n)) / np.sqrt(128)).astype(np.float32)
          for n in (128, 64, 64)]
    js = jawq.search_awq_scale_shared([jnp.asarray(x)],
                                      [jnp.asarray(w) for w in ws],
                                      jawq.AWQConfig())
    ts = tawq.search_awq_scale_shared([x], [torch.from_numpy(w) for w in ws],
                                      tawq.AWQConfig())
    w_cat = np.concatenate(ws, axis=1)
    _, j_losses = _jax_losses(x, w_cat, jawq.AWQConfig())
    t_cands, _ = _port_losses(x, w_cat, tawq.AWQConfig())
    t_idx = int(np.flatnonzero((t_cands == ts.numpy()).all(axis=1))[0])
    if _assert_same_pick(j_losses, t_idx):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **CAND)


def test_fold_into_norm_matches_jax():
    rng = np.random.default_rng(9)
    gamma = rng.standard_normal(96).astype(np.float32)
    inv_s = rng.uniform(0.1, 3.0, 96).astype(np.float32)
    want = np.asarray(jawq.fold_into_norm(jnp.asarray(gamma),
                                          jnp.asarray(inv_s)))
    got = tawq.fold_into_norm(torch.from_numpy(gamma), torch.from_numpy(inv_s))
    np.testing.assert_array_equal(got.numpy(), want)
    # the fold is the explicit multiply: norm(x) * gamma * inv_s
    h = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    np.testing.assert_allclose((h * got).numpy(),
                               (h * torch.from_numpy(gamma)
                                * torch.from_numpy(inv_s)).numpy(),
                               rtol=1e-6)


def test_capture_name_of_a_layer_linear():
    assert tpipe.capture_name(["segments", "seg_0", "3", "attn", "wq"]) == \
        "segments/seg_0/attn/wq@3"
    assert tpipe.capture_name(["segments", "seg_1", "12", "mlp", "down"]) \
        == "segments/seg_1/mlp/down@12"
    assert tpipe.capture_name(["lm_head"]) == "lm_head"


@pytest.fixture(scope="module")
def smoke_quantized():
    """The smoke model's JAX calibration stats, quantized by both
    packages: (JAX params, JAX report, port params, port report, stats,
    port float params)."""
    cfg = jcfgs.smoke_config()
    m = jbuild(cfg)
    jp = m.init(jax.random.PRNGKey(0))
    batch = jmake(cfg, 2, 64, seed=123).batch_at(0)
    with jcal.CalibrationCapture() as cap:
        m.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    acfg = jawq.AWQConfig(quant=JQuantConfig(group_size=64))
    jq, jrep = jpipe.quantize_params(jp, cap.stats, acfg)
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    tq, trep = tpipe.quantize_params(
        tp, cap.stats, tawq.AWQConfig(quant=QuantConfig(group_size=64)))
    return jq, jrep, tq, trep, cap.stats, tp


def _layerless(path):
    """Port report path → the reference's (one entry per stacked param)."""
    parts = path.split("/")
    return "/".join(parts[:2] + parts[3:])


def test_calibrated_quantize_params_lists_match_jax(smoke_quantized):
    _, jrep, _, trep, stats, _ = smoke_quantized
    n_layers = jcfgs.smoke_config().num_layers
    for attr in ("quantized", "skipped", "calibrated"):
        tl, jl = getattr(trep, attr), getattr(jrep, attr)
        assert len(tl) == n_layers * len(jl), attr
        assert sorted(set(map(_layerless, tl))) == sorted(jl), attr
    assert trep.calibrated == trep.quantized
    assert len(trep.calibrated) == 10 and len(trep.skipped) == 4
    assert trep.packed_bytes == jrep.packed_bytes
    assert trep.dense_bytes_fp16 == jrep.dense_bytes_fp16
    assert trep.compression_ratio == jrep.compression_ratio
    assert all(tpipe.capture_name(p.split("/")) in stats
               for p in trep.calibrated)


def test_calibrated_packed_bytes_match_jax(smoke_quantized):
    jq, _, tq, trep, stats, tp = smoke_quantized
    jtree = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jq),
                                   device="cpu")
    seg_j = jtree["segments"]["seg_0"]
    agreed = 0
    for path in trep.calibrated:
        _, _, i, grp, name = path.split("/")
        got = tq["segments"]["seg_0"][int(i)][grp][name]
        ref = seg_j[int(i)][grp][name]
        assert isinstance(got, PackedLinear)
        assert not torch.equal(got.input_scale, torch.ones_like(
            got.input_scale))                     # the search ran
        if np.allclose(got.input_scale.numpy(), ref.input_scale.numpy(),
                       rtol=2e-5, atol=0):
            agreed += 1
            for f in ("qweight", "zeros"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), \
                    (path, f)
            np.testing.assert_allclose(got.scales.numpy(),
                                       ref.scales.numpy(), rtol=2e-5)
            continue
        # another pick: only allowed on a tie of the JAX losses
        st = stats[tpipe.capture_name(path.split("/"))]
        wf = tp["segments"]["seg_0"][int(i)][grp][name]["w"].numpy()
        t_cands, _ = _port_losses(st.rows, wf, tawq.AWQConfig())
        _, j_losses = _jax_losses(st.rows, wf, jawq.AWQConfig())
        t_idx = int(np.argmin(np.abs(
            1.0 / t_cands - got.input_scale.numpy()[None]).max(axis=1)))
        assert not _assert_same_pick(j_losses, t_idx)
    # the byte check must not go vacuous: ties are rare (none on this
    # model at the time of writing), so at most two may take the other arm
    assert agreed >= len(trep.calibrated) - 2


def test_quantize_params_keeps_the_rtn_callers():
    """A bare `QuantConfig` and ``calib=None`` are the round-to-nearest
    path: unit input scales, one AWQConfig default search never run."""
    cfg = jcfgs.smoke_config()
    jp = jbuild(cfg).init(jax.random.PRNGKey(1))
    tp = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    q1, r1 = tpipe.quantize_params(tp, None, QuantConfig(group_size=64))
    q2, r2 = tpipe.quantize_params(tp)
    assert r1.calibrated == r2.calibrated == []
    a = q1["segments"]["seg_0"][1]["mlp"]["down"]
    b = q2["segments"]["seg_0"][1]["mlp"]["down"]
    assert torch.equal(a.qweight, b.qweight)
    assert torch.equal(a.input_scale, torch.ones_like(a.input_scale))
