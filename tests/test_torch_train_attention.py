"""Port parity: hymba's training and the train attention's route to K4 /
K4b, against the reference.

hymba-1.5b (attention ∥ SSD in every layer) at G 5 over its global and
windowed layers, and at S not a multiple of ``ssm_chunk``: loss and every
gradient leaf against ``jax.value_and_grad(Model.loss)``, with the rule
and helpers of `test_torch_train_families.py` (f32 activations, loss /
ce / aux at rtol 2e-5, each leaf within 1e-4 of its largest magnitude).
Then `attention` in train mode at the published head dims and heads of
the four models whose attention trains through K4 / K4b (hubert hd 80
bidirectional, phi-3-vision hd 96, hymba G 5 global and 1,024-windowed,
qwen2-moe hd 128 G 1): output and vjp against the reference's jnp
attention, and the call counted through `FlashAttentionFn` (the plain
versions on the CPU). Last, the chip smoke's `train_families` batches
against the reference's pipeline.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import make_dataset as jmake_dataset
from repro.models import attention as jattention
from repro.utils.tree import flatten_with_paths as jflatten
import repro_torch.configs as tconfigs
from repro_torch.bridge import tree_to_torch
from repro_torch.data.pipeline import make_dataset
from repro_torch.kernels import flash_attention as k4
from repro_torch.models import attention as tattention
from tests.test_torch_train_families import (  # noqa: F401
    _assert_parity, _np, _one_thread, _parity)  # _one_thread: autouse here


@pytest.mark.parametrize("b,s,kw", [
    (2, 64, dict(num_heads=5, num_kv_heads=1)),    # G 5: windowed + global
    (1, 40, {})])                                  # one SSD chunk
def test_hybrid_gradients_match_reference(b, s, kw):
    ref, port, _, _ = _parity("hymba-1.5b", b, s, **kw)
    got = _assert_parity(ref, port)
    assert {"segments/seg_0/attn/wq/w", "segments/seg_0/ssm/wx/w",
            "segments/seg_0/ssm/a_log"} <= set(got)


# (name, S, causal, window, overrides): the train attention at the
# published head dims and heads, one layer's params
ATTN_CASES = {
    "hubert-hd80-bidirectional": ("hubert-xlarge", 64, False, 0, {}),
    "phi3v-hd96-causal": ("phi-3-vision-4.2b", 64, True, 0, {}),
    "hymba-g5-global": ("hymba-1.5b", 64, True, 0, {}),
    "hymba-g5-window": ("hymba-1.5b", 1100, True, 1024, {}),
    "qwen2moe-hd128-g1": ("qwen2-moe-a2.7b", 64, True, 0, {}),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_train_attention_routes_through_k4_and_k4b(case, monkeypatch):
    """`attention` in train mode at the published widths: the forward and
    its vjp (random cotangent) equal the reference's jnp attention within
    the f32 rule (2e-5 of the output's scale; 1e-4 of each gradient's
    largest magnitude), and the port's call went through
    `FlashAttentionFn` once forward (K4 with lse) and once backward
    (K4b), with the config's head dim, heads and mask."""
    name, s, causal, window, kw = ATTN_CASES[case]
    jcfg = dataclasses.replace(jconfigs.get_config(name),
                               activation_dtype="float32", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(name),
                               activation_dtype="float32", **kw)
    calls = []
    fwd, bwd = k4.flash_attention_lse_ref, k4.flash_attention_bwd

    def counted_fwd(q, k, v, **kwa):
        calls.append(("k4", tuple(q.shape), k.shape[1], kwa["causal"],
                      kwa["window"]))
        return fwd(q, k, v, **kwa)

    def counted_bwd(*a, **kwa):
        calls.append(("k4b", kwa["causal"], kwa["window"]))
        return bwd(*a, **kwa)
    monkeypatch.setattr(k4, "flash_attention_lse_ref", counted_fwd)
    monkeypatch.setattr(k4, "flash_attention_bwd", counted_bwd)

    jp = jattention.attn_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]

    def jfn(p, xx):
        return jattention.attention(p, xx, jcfg, positions=jnp.asarray(pos),
                                    window=window, causal=causal)
    jout, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))

    tp = tree_to_torch(_np(jp), device="cpu")
    leaves = [t.requires_grad_(True) for _, t in state_to_arrays_paths(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    with torch.enable_grad():
        out = tattention.attention(tp, tx, tcfg,
                                   positions=torch.from_numpy(pos),
                                   window=window, causal=causal)
        out.backward(torch.from_numpy(ct))
    scale = float(np.abs(np.asarray(jout)).max())
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() \
        <= 2e-5 * scale
    got = {"x": tx.grad.numpy(), **{p: t.grad.numpy() for p, t in
                                    state_to_arrays_paths(tp)}}
    want = {"x": np.asarray(jgx), **{p: np.asarray(a)
                                     for p, a in jflatten(jgp)}}
    assert set(got) == set(want) and leaves
    for path, w in want.items():
        lim = 1e-4 * max(np.abs(w).max(), 1e-30)
        assert np.abs(got[path] - w).max() <= lim, path
    hd = tcfg.head_dim
    assert calls == [("k4", (1, tcfg.num_heads, s, hd), tcfg.num_kv_heads,
                      causal, window), ("k4b", causal, window)]
    assert hd in k4.BWD_HEAD_DIMS


def state_to_arrays_paths(tree, prefix=""):
    """``[(path, tensor)]`` of a one-layer param tree (no lists), the
    tensors themselves (not copies), in the reference's path form."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out += state_to_arrays_paths(v, p)
        elif v is not None:
            out.append((p, v))
    return out


@pytest.mark.parametrize("name,b,s", [("hubert-xlarge", 2, 1024),
                                      ("phi-3-vision-4.2b", 2, 256)])
def test_train_batches_equal_reference_at_the_card_shapes(name, b, s):
    """The chip smoke's `train_families` batches at the published dims:
    hubert's frames with codeword labels, phi-3-vision's tokens, labels
    over the text and 256 patch embeddings, bit-equal to the reference's
    `make_dataset` (`batch_at` 0 and 3)."""
    ds = make_dataset(tconfigs.get_config(name), b, s)
    jds = jmake_dataset(jconfigs.get_config(name), b, s)
    for step in (0, 3):
        got, want = ds.batch_at(step), jds.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = {"hubert-xlarge": {"features", "labels"},
            "phi-3-vision-4.2b": {"tokens", "labels", "images"}}[name]
    assert set(got) == keys
