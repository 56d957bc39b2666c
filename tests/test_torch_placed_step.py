"""The placed one-shot step in the port: `Model.prefill(mesh=)` and
`Model.decode_step(mesh=)` with parameters placed by `param_pspec`
(`shard_params`; `replica_params`'s lists under a data axis) and the
decode cache by `cache_pspec` (`place_cache`), held against the JAX
package. This file: the dense decoders and the VLM; the other families
are in `test_torch_placed_step_families.py`, which shares its harness.

Each smoke config runs at f32 activations, compute and caches (a bf16
cache rounds a last-bit difference of an S-striped read's combine into a
visible step), its weights from
the reference's `Model.init` crossed through `bridge.py`, B 4, then 3
greedy decode steps fed the reference's tokens, under (1 × 2), (1 × 4)
and (2 × 4) meshes of ``"cpu"`` devices. Two cache lengths take the
rule's k / v layouts: 64 after a 40-token prompt (stripes along S;
windowed rings of 32 wrap) and 12 after an 8-token one (too short to
stripe: over the kv heads where they divide — glm4-9b's 2 at ``model``
2 — else whole; the VLM's 8 patches lengthen both).

  * against the reference's unplaced `prefill` / `decode_step` (GSPMD
    computes the same function when it places them): logits within
    2e-2, the reference's own bound (`tests/test_distributed.py:100`),
    and the cache after prefill within 2e-2 of the reference's
    (`bridge.cache_to_torch`);
  * against the port's unplaced step: logits within 1e-4, greedy tokens
    equal on every row whose top-2 margin clears twice that;
  * cache bytes: every piece's shape is `NamedSharding(mesh,
    cache_pspec(...)).shard_shape`, and the pieces joined
    (`join_cache`) equal, byte for byte after prefill and after each
    step, the cache of the unplaced step run over the same sequence
    stripes (`shard_cache`: the plain cache where S does not stripe),
    so the placement of the parameters moves no cached byte;
  * the fused-sample head: `decode_step(greedy=True)` returns the
    argmax of the logits, the first maximum across shards on a tie;
  * the collective counter on a (1 × 2) placed decode step, counted by
    hand, with and without the fused-sample head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import pipeline as jpipe
from repro.core import qlinear as jql
from repro.models import build_model as jbuild
import repro_torch.configs as tconfigs
from repro_torch import bridge
from repro_torch.core import qlinear as tql
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.roofline import analysis
from repro_torch.utils.tree import map_tree

MESHES = [(1, 2), (1, 4), (2, 4)]
B, STEPS = 4, 3
# cache length → prompt: 64 holds a 40-token prompt (windowed rings of 32
# wrap) striped along S; 12 holds an 8-token one, too short to stripe
LONG, SHORT = 64, 12
PROMPTS = {LONG: 40, SHORT: 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _f32_compute():
    jql.set_execution_config(compute_dtype=jnp.float32)
    with tql.execution_config(tql.ExecutionConfig(
            compute_dtype=torch.float32)):
        yield
    jql.set_execution_config(compute_dtype=jnp.bfloat16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_case(arch: str, quant: bool = False, **over) -> dict:
    """One smoke config at f32 activations: the reference's model and
    params (RTN-packed with ``quant``) and the port's, bridged."""
    over = dict(over, activation_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if quant:
        jp, _ = jpipe.quantize_params(jp)
    return dict(jm=jm, jp=jp, m=Model(tcfg),
                p=bridge.params_to_torch(_np(jp), device="cpu"))


def _batch(cfg, s: int) -> dict:
    """numpy inputs for a cache of ``s``: its prompt's tokens (and a
    VLM's patches) or an encoder's frames."""
    rng = np.random.default_rng(3)
    prompt = PROMPTS[s]
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal(
            (B, prompt, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, prompt)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["images"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return out


def seq_len(cfg, s: int) -> int:
    """A cache length of ``s`` past the image span (a VLM's prefill holds
    its patches too); an encoder's cache holds its frames."""
    if cfg.is_encoder:
        return PROMPTS[s]
    return s + (cfg.num_patches if cfg.frontend == "vision" else 0)


def reference_run(case: dict, s: int) -> dict:
    """The reference's unplaced prefill, then STEPS greedy decode steps:
    its logits a call, the tokens it fed, its cache after prefill."""
    jm, jp = case["jm"], case["jp"]
    batch = {k: jnp.asarray(v) for k, v in _batch(jm.cfg, s).items()}
    cache = jm.init_cache(B, seq_len(jm.cfg, s), dtype=jnp.float32)
    cache, logits, nxt = jax.jit(jm.prefill)(jp, batch, cache)
    out = dict(logits=[np.asarray(logits)], tokens=[],
               cache=bridge.cache_to_torch(_np(cache), device="cpu"),
               pos=np.asarray(nxt))
    if jm.cfg.is_encoder:
        return out
    step = jax.jit(jm.decode_step)
    pos = nxt
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out["tokens"].append(np.array(tok))
        logits, cache = step(jp, cache, tok, pos)
        out["logits"].append(np.asarray(logits))
        pos = pos + 1
    return out


def _clone(tree):
    return map_tree(lambda t: t.clone(), tree)


def port_run(case: dict, s: int, ref: dict, mesh=None, layout=None
             ) -> dict:
    """The port's prefill and decode steps fed the reference's tokens:
    unplaced over a plain cache, unplaced over ``layout`` (a mesh:
    `shard_cache`'s sequence stripes), or placed under ``mesh``
    (`place_cache`). Logits a call and the logical cache after each
    (the pieces joined)."""
    m, p = case["m"], case["p"]
    cfg = m.cfg
    like = m.init_cache(B, seq_len(cfg, s), torch.float32, device="meta")
    cache = m.init_cache(B, seq_len(cfg, s), torch.float32, device="cpu")
    kw, params, view = {}, p, _clone
    if layout is not None:
        cache = shd.shard_cache(cache, layout)
        view = lambda c: _clone(shd.join_cache(c, layout, like))  # noqa
    if mesh is not None:
        reps = shd.replica_meshes(mesh)
        params = [shd.shard_params(p, rm, cfg) for rm in reps]
        params = params if len(reps) > 1 else params[0]
        cache = shd.place_cache(cache, mesh)
        kw = {"mesh": mesh}
        view = lambda c: _clone(shd.join_cache(c, mesh, like))  # noqa
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, s).items()}
    out = {"logits": [], "caches": [], "placed": cache}
    with torch.no_grad():
        cache, logits, nxt = m.prefill(params, batch, cache, **kw)
        out["logits"].append(logits)
        out["caches"].append(view(cache))
        pos = nxt.to(torch.int32)
        for tok in ref["tokens"]:
            logits, cache = m.decode_step(params, cache,
                                          torch.from_numpy(tok), pos, **kw)
            out["logits"].append(logits)
            out["caches"].append(view(cache))
            pos = pos + 1
    return out


def _pieces(node, path=""):
    """``(path, piece)`` of every tensor of a placed cache (a replica's),
    pieces of a split leaf in shard order."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _pieces(v, f"{path}/{k}" if path else k)
    elif isinstance(node, list):
        for v in node:
            yield from _pieces(v, path)
    else:
        yield path, node


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def check_placed(case: dict, ref: dict, plain: dict, same_stripes: dict,
                 placed: dict, mesh, s: int, exact=lambda path: True,
                 near: float = 0.0) -> None:
    """The rules of this file's docstring for one placed run. ``exact``
    picks the joined cache's leaves held byte for byte (the others
    within ``near`` of their largest magnitude)."""
    cfg = case["m"].cfg
    for i, (r, a, b) in enumerate(zip(ref["logits"], plain["logits"],
                                      placed["logits"])):
        assert b.shape == a.shape, i
        assert float(np.abs(b.numpy() - r).max()) < 2e-2, i
        assert float((a - b).abs().max()) < 1e-4, i
        if a.dim() == 2:
            top2 = torch.topk(a, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2e-4
            assert bool((a.argmax(-1) == b.argmax(-1))[clear].all()), i
    # the cache after prefill against the reference's
    if cfg.kv_quant == "none":
        want = dict(_leaves(ref["cache"]))
        got = dict(_leaves(placed["caches"][0]))
        assert set(got) == set(want)
        for path, g in got.items():
            assert g.shape == want[path].shape, path
            assert float((g.float() - want[path].float()).abs().max()) \
                < 2e-2, path
    # byte for byte against the unplaced step over the same stripes
    for step, (got, want) in enumerate(zip(placed["caches"],
                                           same_stripes["caches"])):
        for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
            if exact(path):
                assert torch.equal(g, w), (step, path)
            else:
                tol = near * max(1.0, float(w.float().abs().max()))
                assert float((g.float() - w.float()).abs().max()) <= tol, \
                    (step, path)
    # every piece is the rule's shard shape on the whole mesh
    like = case["m"].init_cache(B, seq_len(cfg, s), torch.float32,
                                device="meta")
    reps = placed["placed"] if isinstance(placed["placed"], list) \
        else [placed["placed"]]
    shapes = {}
    for path, leaf in _pieces(like):
        spec = shd.cache_pspec(path, leaf, mesh, cfg)
        shapes[path] = shd.NamedSharding(mesh, spec).shard_shape(leaf.shape)
    for rep in reps:
        for path, piece in _pieces(rep):
            assert tuple(piece.shape) == shapes[path], path


def run_case(case: dict, dims, s: int, **kw) -> None:
    """A case's reference run, unplaced runs and placed run on one mesh,
    held by `check_placed`."""
    mesh = make_host_mesh(*dims, devices=["cpu"] * (dims[0] * dims[1]))
    key = ("ref", s)
    if key not in case:
        case[key] = reference_run(case, s)
        case[("plain", s)] = port_run(case, s, case[key])
    ref = case[key]
    layout = make_host_mesh(1, dims[1], devices=["cpu"] * dims[1])
    same = port_run(case, s, ref, layout=layout)
    placed = port_run(case, s, ref, mesh=mesh)
    check_placed(case, ref, case[("plain", s)], same, placed, mesh, s, **kw)
    return placed


CASES = {"qwen25": ("qwen25-05b", {}), "qwen25-int8": (
    "qwen25-05b", {"kv_quant": "int8"}), "qwen25-rtn": ("qwen25-05b", {
        "quant": True}), "glm4": ("glm4-9b", {}), "gemma3": ("gemma3-4b", {}),
    "phi3v": ("phi-3-vision-4.2b", {})}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over = CASES[request.param]
    out = make_case(arch, **over)
    out["key"] = request.param
    return out


@pytest.mark.parametrize("s", [LONG, SHORT], ids=["striped", "short"])
@pytest.mark.parametrize("dims", MESHES, ids=["1x2", "1x4", "2x4"])
def test_placed_step_matches_reference_and_unplaced(case, dims, s):
    """Qwen2.5's smoke config (1 kv head: k / v along S, or whole; bf16,
    int8 and RTN-packed linears), glm4-9b's (2 kv heads of 32: over the
    heads at ``model`` 2 when S is short), gemma3-4b's (windowed layers'
    rings of 32) and phi-3-vision's (patches through ``patch_proj``)."""
    placed = run_case(case, dims, s)
    first = placed["placed"][0] if dims[0] > 1 else placed["placed"]
    kv = first["seg_0"][0]["kv"]["k"]
    n = dims[1]
    cfg = case["m"].cfg
    s_all = case["m"].init_cache(B, seq_len(cfg, s), device="meta")[
        "seg_0"][0]["kv"]["k"].shape[1]           # a ring: its window
    if s_all % n == 0 and s_all >= 8 * n:
        assert isinstance(kv, list) and kv[0].shape[1] == s_all // n
    elif cfg.num_kv_heads % n == 0:
        assert isinstance(kv, list) and kv[0].shape[2] == cfg.num_kv_heads // n
    else:
        assert isinstance(kv, torch.Tensor)


def test_fused_sample_tokens_equal_baseline_argmax():
    """`decode_step(greedy=True)` under (1 × 2) and (2 × 4): each row's
    token is the argmax of the baseline step's logits (tied and untied
    heads, both split over the vocabulary); a maximum that two shards'
    slices share goes to the first shard, as `argmax` gives it."""
    for arch in ("qwen25-05b", "glm4-9b"):
        cfg = tconfigs.get_smoke_config(arch)
        m = Model(cfg)
        p = m.init(torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (B, 10)).astype(np.int32))
        for dims in ((1, 2), (2, 4)):
            mesh = make_host_mesh(*dims, devices=["cpu"] * (dims[0]
                                                            * dims[1]))
            grid = [shd.shard_params(p, rm, cfg)
                    for rm in shd.replica_meshes(mesh)]
            grid = grid if dims[0] > 1 else grid[0]
            cache = shd.place_cache(m.init_cache(B, 16, device="cpu"), mesh)
            with torch.no_grad():
                cache, lg, nxt = m.prefill(grid, {"tokens": toks}, cache,
                                           mesh=mesh)
                tok = lg.argmax(-1).to(torch.int32)
                pos = nxt.to(torch.int32)
                snap = _clone(cache)
                logits, _ = m.decode_step(grid, cache, tok, pos, mesh=mesh)
                got, _ = m.decode_step(grid, snap, tok, pos, mesh=mesh,
                                       greedy=True)
            assert got.dtype == torch.int32 and got.shape == (B,)
            assert torch.equal(got, logits.argmax(-1).to(torch.int32))
    # a tie across the two vocab slices: rows 10 and 300 of a tied table
    cfg = tconfigs.get_smoke_config("qwen25-05b")
    m = Model(cfg)
    x = torch.randn(2, cfg.d_model, generator=torch.Generator().manual_seed(5))
    table = torch.randn(cfg.vocab_size, cfg.d_model,
                        generator=torch.Generator().manual_seed(6)) * 0.01
    table[10] = table[300] = x[0] * 3.0
    devices = [torch.device("cpu")] * 2
    ps = [{"embed": {"table": t.contiguous()}} for t in table.chunk(2)]
    got = m._greedy_tp(ps, x, devices)
    logits = m._head_logits({"embed": {"table": table}}, x)
    assert logits[0, 10] == logits[0, 300] == logits[0].max()
    assert int(got[0]) == 10 == int(logits[0].argmax())
    assert torch.equal(got, logits.argmax(-1).to(torch.int32))


def test_collective_hand_count_placed_decode_step():
    """A (1 × 2) placed decode step of Qwen2.5's smoke config (f32 params,
    bf16 activations; B 2, a cache of 64 striped along S: 2 stripes of
    32), counted by hand, a device's operand: the embedding's
    vocab-parallel pieces summed (f32 [B, D]); per layer the q heads'
    stripes joined (bf16 [B, 1, hd]: 1 of 2 heads a shard; the one kv
    head is projected on the first shard), each stripe's partial max,
    sum and output joined for the combine (f32 [1, B, 1, 2, 1, 1] twice,
    [1, B, 1, 2, 1, hd]), the combined output cut for the row-parallel
    ``wo`` (bf16 [B, D / 2]) and ``wo``'s and ``down``'s partials summed
    (f64 [B, D] on the CPU); the head's vocab slices joined (f32 [B,
    V / 2]) or, fused-sample, each shard's [B] maximum (f32) and index
    (int32)."""
    cfg = tconfigs.get_smoke_config("qwen25-05b")
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = shd.serving_mesh(2, devices=["cpu"] * 2)
    sp = shd.shard_params(p, mesh, cfg)
    b, d, hd, L = 2, cfg.d_model, cfg.head_dim, cfg.num_layers
    toks = torch.arange(b * 6, dtype=torch.int32).reshape(b, 6)
    per_layer = {"concat": 4, "split": 1, "all_sum": 2}
    nbytes = {"concat": b * hd * 2 + 2 * (b * 2 * 4) + b * 2 * hd * 4,
              "split": b * d // 2 * 2, "all_sum": 2 * b * d * 8}
    for greedy in (False, True):
        cache = shd.place_cache(m.init_cache(b, 64, device="cpu"), mesh)
        with torch.no_grad():
            cache, lg, nxt = m.prefill(sp, {"tokens": toks}, cache,
                                       mesh=mesh)
            with analysis.count_collectives() as n:
                m.decode_step(sp, cache, lg.argmax(-1).to(torch.int32),
                              nxt.to(torch.int32), mesh=mesh, greedy=greedy)
        head = (2, 2 * b * 4) if greedy else (1, b * cfg.vocab_size // 2 * 4)
        assert n.calls == {"all_sum": 1 + per_layer["all_sum"] * L,
                           "concat": per_layer["concat"] * L + head[0],
                           "split": per_layer["split"] * L}
        assert n.by_op == {"all_sum": b * d * 4 + nbytes["all_sum"] * L,
                           "concat": nbytes["concat"] * L + head[1],
                           "split": nbytes["split"] * L}
        costs = analysis.collective_costs(n)
        assert costs["total"] == n.total
        assert costs["all-gather"] == n.by_op["concat"]


def test_linear_tp_joins_an_input_scale_split_apart_from_its_words():
    """A packed row-parallel linear whose rule splits its input scale
    (K divides over the shards) but not its words (K / 8 does not), as
    deepseek-v2-lite's dense ``down`` (K 10,944) at 16 shards: each shard
    scales its slice of the input, the slices are joined and the first
    shard runs the whole product, which equals the unsharded linear's
    bits. Here K 48 over 4 (words 6 rows, groups of 16: 3)."""
    from repro_torch.core.packing import pack_linear
    from repro_torch.core.quantize import QuantConfig, quantize_groupwise
    from repro_torch.models import layers
    qc = QuantConfig(group_size=16)
    gen = torch.Generator().manual_seed(7)
    w = torch.randn(48, 32, generator=gen)
    q, sc, z = quantize_groupwise(w, qc)
    lin = pack_linear(q, sc, z, torch.rand(48, generator=gen) + 0.5, None,
                      qc)
    mesh = shd.serving_mesh(4, devices=["cpu"] * 4)
    ps = [t["mlp"]["down"] for t in shd.shard_params({"mlp": {"down": lin}},
                                                     mesh)]
    assert ps[0].qweight.shape == lin.qweight.shape
    assert ps[0].input_scale.shape == (12,)
    x = torch.randn(3, 48, generator=gen)
    with analysis.count_collectives() as n:
        got = layers.linear_tp(ps, x, [torch.device("cpu")] * 4, 48, 32)
    assert torch.equal(got, layers.linear(lin, x))
    assert n.calls == {"split": 1, "concat": 1}
