"""`launch.specs`' shape builders against the reference's: every leaf's
shape, dtype and spec for every arch's smoke config, and each device's
shard bytes.

The reference builds ``jax.eval_shape`` structs with NamedShardings on a
jax Mesh, which needs as many devices as the mesh: its side runs in a
subprocess with 8 forced host devices (as `tests/test_distributed.py`
does) and prints, for each arch and mesh, each builder's leaves as
``[shape, dtype, spec]``. The port's builders make ``meta`` tensors:
nothing is allocated, which the test checks as well.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_host_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MESHES = [(2, 2), (1, 4), (2, 4)]

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, numpy as np
from jax.sharding import Mesh
import repro.configs as C
from repro.launch import specs as S
from repro.utils.tree import flatten_with_paths

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

def rows(tree):
    return {p: [list(x.shape), str(x.dtype), spec(x.sharding.spec)]
            for p, x in flatten_with_paths(tree)}

out = {}
for dp, mp in MESHES:
    mesh = Mesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("data", "model"))
    for arch in C.list_archs():
        cfg = C.get_smoke_config(arch)
        key = f"{arch}|{dp}x{mp}"
        rec = {"params": rows(S.param_specs(cfg, mesh, False)),
               "state": rows(S.train_state_specs(cfg, mesh)[0]),
               "cache": rows(S.cache_specs(cfg, mesh, 8, 64)),
               "tokens": rows(S.decode_token_specs(mesh, 8))}
        if (dp, mp) == (2, 4):
            rec["params_awq"] = rows(S.param_specs(cfg, mesh, True))
        for cell in C.cells_for(arch):
            rec[f"batch_{cell}"] = rows(S.batch_specs(cfg, C.SHAPES[cell],
                                                      mesh))
        out[key] = rec
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    code = SCRIPT.replace("MESHES", repr(MESHES))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")]
    return json.loads(line[0][len("RESULT:"):])


def _rows(leaves: dict) -> dict:
    return {p: [list(v.shape), str(v.dtype).split(".")[-1],
                json.loads(json.dumps(list(v.spec)))]
            for p, v in leaves.items()}


@pytest.mark.parametrize("dp,mp", MESHES)
def test_builders_match_reference(reference, dp, mp):
    """For every arch's smoke config: the params (float; AWQ-packed at GS
    64 on the (2 × 4) mesh), the train state with ZeRO-1 moments, the
    decode cache, each cell's batch and the decode tokens, leaf for leaf
    in the reference's paths and order."""
    mesh = make_host_mesh(dp, mp, devices=["meta"] * (dp * mp))
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    for arch in configs.list_archs():
        cfg = configs.get_smoke_config(arch)
        ref = reference[f"{arch}|{dp}x{mp}"]
        got = {"params": _rows(S.param_specs(cfg, mesh, False)),
               "state": _rows(S.train_state_specs(cfg, mesh)),
               "cache": _rows(S.cache_specs(cfg, mesh, 8, 64))}
        tok = _rows({str(i): v for i, v in enumerate(
            S.decode_token_specs(mesh, 8))})
        assert list(tok.values()) == list(ref["tokens"].values()), arch
        if (dp, mp) == (2, 4):
            got["params_awq"] = _rows(S.param_specs(cfg, mesh, True))
        for cell in configs.cells_for(arch):
            got[f"batch_{cell}"] = _rows(S.batch_specs(
                cfg, configs.SHAPES[cell], mesh))
        for name, rows in got.items():
            assert list(rows) == list(ref[name]), (arch, name)
            for path, row in rows.items():
                assert row == ref[name][path], (arch, name, path)
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


def test_shard_shapes_and_bytes():
    """A leaf's piece a device divides each split dim by its mesh axes
    (a batch dim over ``(pod, data)`` by both); `shard_bytes` sums the
    pieces, every leaf of the tree on every device."""
    mesh = make_host_mesh(2, 4, devices=["meta"] * 8)
    cfg = configs.get_config("qwen25-05b")
    params = S.param_specs(cfg, mesh, True)
    table = params["embed/table"]
    assert table.spec == ("model", None)
    assert table.shard_shape() == (151936 // 4, 896)
    assert table.shard_bytes() == 151936 // 4 * 896 * 4      # f32
    wq = params["segments/seg_0/attn/wq/qweight"]
    assert wq.shape == (24, 896 // 8, 896) and wq.dtype == torch.int32
    assert wq.spec == (None, None, None)      # 14 heads over 4: whole
    down = params["segments/seg_0/mlp/down/qweight"]
    assert down.spec == (None, "model", None)
    assert down.shard_bytes() == 24 * 4864 // 8 // 4 * 896 * 4
    assert S.shard_bytes(params) == sum(v.shard_bytes()
                                        for v in params.values())
    state = S.train_state_specs(cfg, mesh)
    m = state["opt/m/segments/seg_0/mlp/down/w"]
    assert m.spec == ("data", "model", None)  # ZeRO-1 on the layer dim
    assert m.shard_shape() == (12, 4864 // 4, 896)
    multi = make_host_mesh(1, 1, devices=["meta"])
    multi.shape = {"pod": 2, "data": 16, "model": 16}
    multi.axis_names = ("pod", "data", "model")
    tok = S.batch_specs(cfg, configs.SHAPES["train_4k"], multi)["tokens"]
    assert tok.spec == (("pod", "data"), None)
    assert tok.shard_shape() == (256 // 32, 4096)
    assert all(t.meta.device.type == "meta" for t in state.values())
