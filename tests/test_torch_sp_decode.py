"""SP-decode in the port: `cache_pspec` and `_resolve` against the
reference's rules, and `Model.prefill` / `decode_step` over a decode cache
striped along the sequence over ``model`` (`shard_cache`) against the
unsharded one-shot decode.

The reference holds its SP-decode to the unsharded decode at 2e-2 on the
logits (`tests/test_distributed.py:86-102`); the port is held the same
way, and its greedy tokens equal the unsharded ones on every row whose
top-2 margin clears twice that. On the CPU each stripe's scores run as
`_sdpa`'s (f64 products rounded to f32, f32 softmax) and the partials
combine in f32 in shard order, so the logits sit far inside that bound.
The reference's rules take a mesh only through its ``shape`` and
``axis_names``: they are read here on a stand-in mesh of those two.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.distributed import sharding as rshd
from repro.models import build_model
from repro.utils.tree import flatten_with_paths as ref_flatten

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_host_mesh
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


MESHES = [(2, 2), (1, 4), (2, 4)]


@dataclasses.dataclass
class _RefMesh:
    """What the reference's rules read of a jax Mesh."""
    shape: dict
    axis_names: tuple


def _meshes(dp, mp):
    return (_RefMesh({"data": dp, "model": mp}, ("data", "model")),
            make_host_mesh(dp, mp, devices=["meta"] * (dp * mp)))


def test_logical_rules_and_resolve_match_reference():
    assert shd.LOGICAL_RULES == rshd.LOGICAL_RULES
    for dp, mp in MESHES + [(16, 16)]:
        rm, pm = _meshes(dp, mp)
        for logical, shape in (
                (("batch", None), (256, 4096)),
                (("batch", "model", None), (8, 64, 32)),
                (("batch", "heads", "seq"), (6, 8, 64)),
                (("kv_heads", "cache_seq"), (4, 4)),
                (("expert_cap", "ffn"), (3, 12)),
                (("vocab", None, "batch"), (512, 5, 2))):
            assert shd._resolve(pm, logical, shape) == tuple(
                rshd._resolve(rm, logical, shape)), (logical, shape)
    multi = _RefMesh({"pod": 2, "data": 16, "model": 16},
                     ("pod", "data", "model"))
    pmulti = make_host_mesh(1, 1, devices=["meta"])
    pmulti.shape, pmulti.axis_names = dict(multi.shape), multi.axis_names
    assert shd._resolve(pmulti, ("batch", None), (256, 8)) == \
        tuple(rshd._resolve(multi, ("batch", None), (256, 8))) == \
        (("pod", "data"), None)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch", configs.list_archs())
def test_cache_pspec_matches_reference(arch, kv_quant):
    """Every leaf of every config's smoke decode cache (batch 8, max_seq
    64; 16 and 4 too, where S cannot stripe) gets the reference's spec
    under (2 × 2), (1 × 4) and (2 × 4): on the reference's stacked leaf
    exactly, on the port's layer leaf right-aligned."""
    rcfg = dataclasses.replace(ref_smoke(arch), kv_quant=kv_quant)
    pcfg = dataclasses.replace(configs.get_smoke_config(arch),
                               kv_quant=kv_quant)
    for batch, seq in ((8, 64), (4, 16), (2, 4)):
        rcache = jax.eval_shape(
            lambda: build_model(rcfg).init_cache(batch, seq))
        ref = dict(ref_flatten(rcache))
        for dp, mp in MESHES:
            rm, pm = _meshes(dp, mp)
            got = S.cache_specs(pcfg, pm, batch, seq)
            assert set(got) == set(ref)
            cache = Model(pcfg).init_cache(batch, seq, device="meta")
            layer = shd.pspec_tree(cache, pm, shd.cache_pspec)
            named = shd.make_sharding(cache, pm, shd.cache_pspec)
            assert named["seg_0"][0] == {
                kind: {n: shd.NamedSharding(pm, sp) for n, sp in lv.items()}
                for kind, lv in layer["seg_0"][0].items()}
            for path, leaf in got.items():
                want = tuple(rshd.cache_pspec(path, ref[path], rm, rcfg))
                assert leaf.shape == ref[path].shape, path
                assert str(leaf.dtype).split(".")[-1] == str(
                    ref[path].dtype), path
                assert leaf.spec == want, (path, dp, mp)
            for si, seg in layer.items():
                for kind, leaves in seg[0].items():
                    for name, spec in leaves.items():
                        want = got[f"{si}/{kind}/{name}"].spec
                        assert (None,) + spec == want, (si, kind, name)


def _decode_pair(arch: str, mesh, kv_quant="none", steps: int = 4,
                 prompt: int = 20, batch: int = 8, max_seq: int = 64):
    """Prefill then greedy decode steps on an unsharded cache and on the
    same cache striped by `shard_cache`: per step (unsharded, SP)
    logits."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              kv_quant=kv_quant)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (batch, prompt)).astype(np.int32))
    plain = m.init_cache(batch, max_seq, device="cpu")
    striped = shd.shard_cache(m.init_cache(batch, max_seq, device="cpu"),
                              mesh)
    out = []
    with torch.no_grad():
        plain, a, nxt = m.prefill(p, {"tokens": toks}, plain)
        striped, b, _ = m.prefill(p, {"tokens": toks}, striped)
        out.append((a, b))
        tok, pos = a.argmax(-1).to(torch.int32), nxt.to(torch.int32)
        for _ in range(steps):
            a, plain = m.decode_step(p, plain, tok, pos)
            b, striped = m.decode_step(p, striped, tok, pos)
            out.append((a, b))
            tok, pos = a.argmax(-1).to(torch.int32), pos + 1
    return striped, out


def _hold(pairs):
    """The reference's rule: logits within 2e-2; greedy tokens equal on
    rows whose top-2 margin clears twice that."""
    for a, b in pairs:
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) < 2e-2
        top2 = torch.topk(a, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 4e-2
        assert bool((a.argmax(-1) == b.argmax(-1))[clear].all())


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen25-05b", "none"), ("qwen25-05b", "int8"), ("glm4-9b", "none"),
    ("gemma3-4b", "none"), ("hymba-1.5b", "none")])
def test_sp_decode_matches_unsharded_decode(arch, kv_quant):
    """Qwen2.5's smoke config under (2 × 4) (max_seq 64: 4 stripes of 16,
    bf16 and int8 caches), glm4-9b's (hd 32), gemma3's (windowed layers'
    rings of 32: stripes of 8) and hymba's (attention ∥ SSD: only the
    attention leaves stripe): the prefill writes every stripe's slots,
    and each decode step's new token lands in the stripe that owns its
    position (20 … 23 in stripe 1)."""
    pm = make_host_mesh(2, 4, devices=["cpu"] * 8)
    striped, pairs = _decode_pair(arch, pm, kv_quant)
    _hold(pairs)
    kinds = Model(configs.get_smoke_config(arch)).cfg.layer_kinds()
    layers = [c for seg in striped.values() for c in seg]
    for kind, c in zip(kinds, layers):
        if "kv" not in c:
            continue
        for name, parts in c["kv"].items():
            assert isinstance(parts, list) and len(parts) == 4, name
            assert len({t.shape[1] for t in parts}) == 1
        assert bool(c["kv"]["k"][1].float().abs().sum() > 0)
        assert not bool(c["kv"]["k"][3].float().abs().sum() > 0) \
            or kind.window           # a ring wraps onto every stripe
    if "ssm" in layers[0]:
        assert isinstance(layers[0]["ssm"]["state"], torch.Tensor)


def test_sp_decode_on_a_model_mesh_of_two_and_a_data_axis():
    """(1 × 2) and (2 × 2) meshes give the same logits (the data axis
    replicates the cache), a mesh of 1 leaves the cache whole, and a
    cache too short to stripe (S < 8 |model|) stays whole on the first
    shard: the decode then is the unsharded one."""
    outs = []
    for dp in (1, 2):
        pm = make_host_mesh(dp, 2, devices=["cpu"] * (2 * dp))
        _, pairs = _decode_pair("qwen25-05b", pm, steps=2)
        _hold(pairs)
        outs.append(torch.stack([b for _, b in pairs]))
    assert torch.equal(outs[0], outs[1])
    one = shd.shard_cache(Model(configs.get_smoke_config("qwen25-05b"))
                          .init_cache(2, 64, device="cpu"),
                          make_host_mesh(1, 1, devices=["cpu"]))
    assert isinstance(one["seg_0"][0]["kv"]["k"], list)
    short, pairs = _decode_pair("qwen25-05b", make_host_mesh(
        1, 4, devices=["cpu"] * 4), steps=1, prompt=6, max_seq=16)
    assert isinstance(short["seg_0"][0]["kv"]["k"], torch.Tensor)
    for a, b in pairs:
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,kv_quant,prompt", [
    ("qwen25-05b", "int8", 20), ("gemma3-4b", "none", 40)])
def test_prefill_writes_each_stripe_its_own_slots(arch, kv_quant, prompt):
    """A prefill into a cache striped 4 ways (S 64: stripes of 16; gemma3's
    windowed rings of 32: stripes of 8, wrapped by a 40-token prompt)
    writes the unsharded prefill's bytes, each stripe its own slots and
    nothing joined on one device: the collectives it counts are one
    `split` a striped leaf, a device's operand one stripe."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              kv_quant=kv_quant)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, prompt)).astype(np.int32))
    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    plain = m.init_cache(2, 64, device="cpu")
    striped = shd.shard_cache(m.init_cache(2, 64, device="cpu"), mesh)
    with torch.no_grad():
        plain, a, _ = m.prefill(p, {"tokens": toks}, plain)
        with shd.count_collectives() as n:
            striped, b, _ = m.prefill(p, {"tokens": toks}, striped)
    assert torch.equal(a, b)
    calls, nbytes = 0, 0
    for seg, cs in striped.items():
        for cp, c in zip(plain[seg], cs):
            for name, parts in c["kv"].items():
                assert len(parts) == 4
                assert torch.equal(torch.cat(parts, 1), cp["kv"][name]), name
                calls += 1
                nbytes += parts[0].numel() * parts[0].element_size()
    assert n.calls == {"split": calls} and n.by_op == {"split": nbytes}
