"""Tensor parallelism of the MLA, SSM, hybrid, encoder and VLM families
in the port, held against the JAX package: the rules and the packed
forward under a ``(data, model)`` mesh.

Five smoke configs (deepseek-v2-lite: MLA + MoE, a dense first layer;
mamba2: SSD; hymba: attention ∥ SSD; hubert: the audio encoder;
phi-3-vision: patches before the text) and three variants for the
hazards of a stripe: hymba with SSM heads of 128 (2 heads: at ``model``
4 an ``wx`` stripe of 64 cuts a head and ``wdt`` stays whole, so the
heads run joined on the first shard), deepseek with d_ff 320 (a packed
``down``'s K-shard of 160 or 80 would cut a 64-row quant group: it flips
to column-parallel) and hymba with a vocabulary of 511 (odd, as its
published 32,001: the tied table splits over d, the lookup joins the
shards' columns and the head sums their partial products).

  * rules — the port's `param_pspec` and `zero1_pspec` give the
    reference's spec for every leaf of the float and the RTN-packed
    smoke trees at ``model`` 2 and 4 with ``data`` 2 (a reference leaf
    stacks the layers: its spec is the port's with a leading None);
  * the packed forward — `Model.forward_logits(mesh=)` from the bridged
    RTN-packed reference params under (1 × 2), (2 × 2) and (1 × 4)
    against the reference's meshless `forward_logits`, f32 activations
    and compute, within 1e-4 (as `test_torch_moe_mesh.py`); phi-3-
    vision's batch carries its patches, hubert's its frames.

Shards live on the CPU in this one process (meshes over ``["cpu"] * n``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.data import make_dataset as jmake_dataset
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild
from repro.utils.tree import flatten_with_paths as jflatten
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import qlinear as tql
from repro_torch.distributed import sharding as tshd
from repro_torch.models.model import Model
from repro_torch.utils.tree import layer_parts

ARCHS = {"deepseek": ("deepseek-v2-lite-16b", {}),
         "mamba2": ("mamba2-130m", {}),
         "hymba": ("hymba-1.5b", {}),
         "hubert": ("hubert-xlarge", {}),
         "phi3v": ("phi-3-vision-4.2b", {}),
         "hymba-hd128": ("hymba-1.5b", {"ssm_headdim": 128}),
         "deepseek-ff320": ("deepseek-v2-lite-16b", {"d_ff": 320}),
         "hymba-v511": ("hymba-1.5b", {"vocab_size": 511})}
MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers
    share the machine's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with tql.execution_config(tql.ExecutionConfig(
            compute_dtype=torch.float32)):
        yield
    jql.set_execution_config(compute_dtype=jnp.bfloat16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh(data: int, model: int) -> tshd.Mesh:
    return tshd.Mesh(np.full((data, model), "cpu", dtype=object),
                     ("data", "model"))


def configs_of(key: str, activation_dtype: str = "float32"):
    """(reference config, port config) of one ``ARCHS`` entry."""
    name, over = ARCHS[key]
    over = dict(over, activation_dtype=activation_dtype)
    return (dataclasses.replace(jconfigs.get_smoke_config(name), **over),
            dataclasses.replace(tconfigs.get_smoke_config(name), **over))


@pytest.fixture(scope="module", params=list(ARCHS))
def trees(request):
    """(key, jax model, port model, {"float" | "awq": (jax params, port
    params)}) of one smoke config at f32 activations."""
    jcfg, tcfg = configs_of(request.param)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jq, _ = jpipe.quantize_params(jp)
    return request.param, jm, Model(tcfg), {
        kind: (p, bridge.params_to_torch(_np(p), device="cpu"))
        for kind, p in (("float", jp), ("awq", jq))}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["float", "awq"])
def test_rules_equal_reference(trees, kind, n):
    key, jm, tm, by_kind = trees
    jp, tp = by_kind[kind]
    jmesh = AbstractMesh((2, n), ("data", "model"))
    tmesh = _mesh(2, n)
    want = {}
    for path, leaf in jflatten(jp):
        spec = jshd.param_pspec(path, leaf, jmesh, jm.cfg)
        want[path] = (tuple(spec), tuple(jshd.zero1_pspec(
            spec, tuple(leaf.shape), jmesh)))
    got = {}
    for path, parts, leaf in layer_parts(tp):
        one = parts[0] if parts is not None else leaf
        spec = tshd.param_pspec(path, one, tmesh, tm.cfg)
        shape = tuple(one.shape)
        if parts is not None:
            spec, shape = (None,) + spec, (len(parts),) + shape
        got[path] = (spec, tshd.zero1_pspec(spec, shape, tmesh))
    assert got == want
    split = {p for p, (s, _) in got.items() if "model" in s}
    assert split, "nothing splits over model"
    if key == "deepseek-ff320" and kind == "awq":
        # the hazard: the dense layer's packed down flips to its N
        assert got["segments/seg_0/mlp/down/qweight"][0][-2:] \
            == (None, "model")
    if key == "hymba-v511":
        assert got["embed/table"][0] == (None, "model")
    if key == "hymba-hd128":
        # 2 SSM heads: wdt splits at 2, not at 4 (float, or RTN's words)
        wdt = [s for p, (s, _) in got.items()
               if p in ("segments/seg_0/ssm/wdt/w",
                        "segments/seg_0/ssm/wdt/qweight")]
        assert [("model" in s) for s in wdt] == [n == 2]


def _batch(cfg, b: int = 4, s: int = 64) -> dict:
    """The pipeline's batch without labels: tokens (and a vision config's
    patches) or an audio config's frames."""
    batch = jmake_dataset(cfg, b, s).batch_at(0)
    batch.pop("labels")
    return batch


def _grid(tp, mesh, cfg):
    return [tshd.shard_params(tp, rm, cfg)
            for rm in tshd.replica_meshes(mesh)]


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2", "1x4"])
def test_packed_forward_under_mesh_matches_meshless_reference(trees, shape):
    key, jm, tm, by_kind = trees
    jq, tq = by_kind["awq"]
    batch = _batch(jm.cfg)
    want = np.asarray(jm.forward_logits(
        jq, {k: jnp.asarray(v) for k, v in batch.items()}))
    mesh = _mesh(*shape)
    with torch.no_grad():
        got = tm.forward_logits(_grid(tq, mesh, tm.cfg),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, mesh=mesh)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) < 1e-4
