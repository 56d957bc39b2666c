"""The dry run (`launch.dryrun`), `roofline.analysis` and the collective
counter.

  * A cell's step runs over ``meta`` tensors on a mesh of ``meta``
    devices (here (2 × 2) and (1 × 4) in place of the 16 × 16 production
    mesh, which `--all` takes): the record carries the reference's keys,
    XLA's own as ``null``, ``argument_bytes`` from the rules
    (`launch.specs`), the analytic terms and `model_flops_estimate` as the
    reference computes them; a prefill or decode cell's collective term
    that of the placed one-shot step (parameters by `param_pspec`, the
    cache by `cache_pspec`), its bytes and collectives by hand on
    (2 × 2), every family's prefill and decode on (1 × 4), the
    fused-sample variant's tokens; a failing cell exits 1.
  * `RooflineTerms` is the reference's at the H100's constants (the
    reference's with its TPU constants swapped for the port's gives the
    same record).
  * The counter against hand counts: a (1 × 2) chunk step (the embedding's
    vocab-parallel sum, each layer's wo and down partial sums, the head's
    vocab slices joined) and a (2 × 2) train step (the first replica's
    forward, the gradient reduced over ``data`` in bf16, ZeRO-1's gather
    of the f32 param slices), both counted a device.
"""
import dataclasses
import json
import math

import pytest
import torch

import repro.configs as rconfigs
from repro.roofline import analysis as ranalysis

from repro_torch import configs
from repro_torch.configs import qwen25_05b
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.roofline import analysis


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite's workers share
    the machine's cores, and many small ops otherwise spin on
    oversubscribed thread pools, many times slower than on one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the reference's record keys (`repro/launch/dryrun.py:run_cell`)
REF_KEYS = {"arch", "cell", "mesh", "variant", "chips", "quant", "step",
            "lower_s", "compile_s", "memory_analysis", "collectives",
            "hlo_flops", "hlo_bytes_upper_bound", "raw_cost_analysis",
            "analytic_flops_global", "analytic_bytes_global",
            "analytic_weight_bytes", "analytic_act_bytes",
            "analytic_cache_bytes", "analytic_compute_s",
            "analytic_memory_s", "flops_per_chip", "bytes_per_chip",
            "collective_bytes_per_chip", "chips", "model_flops_global",
            "compute_s", "memory_s", "collective_s", "dominant",
            "step_time_s", "useful_flops_fraction", "roofline_fraction"}
NULL_KEYS = ("compile_s", "hlo_flops", "hlo_bytes_upper_bound",
             "raw_cost_analysis")


def _mesh(dp, mp):
    return make_host_mesh(dp, mp, devices=["meta"] * (dp * mp))


@pytest.mark.parametrize("arch,cell", [("qwen25-05b", "train_4k"),
                                       ("qwen25-05b", "prefill_32k"),
                                       ("qwen25-05b", "decode_32k"),
                                       ("mamba2-130m", "long_500k")])
def test_record_keys_bytes_and_terms(arch, cell, tmp_path):
    mesh = _mesh(2, 2)
    step = configs.SHAPES[cell].step
    quant = step != "train"
    rec = dryrun.run_cell(arch, cell, "single", quant, str(tmp_path),
                          mesh=mesh)
    assert REF_KEYS <= set(rec) and set(rec) - REF_KEYS == {
        "run_s", "collective_calls"}
    assert all(rec[k] is None for k in NULL_KEYS)
    mem = rec["memory_analysis"]
    assert mem["temp_bytes"] is None and mem["code_bytes"] is None
    cfg = configs.get_config(arch)
    c = configs.SHAPES[cell]
    if step == "train":
        want = S.shard_bytes(S.train_state_specs(cfg, mesh),
                             S.batch_specs(cfg, c, mesh))
        assert mem["output_bytes"] == S.shard_bytes(
            S.train_state_specs(cfg, mesh))
        # a data axis: the gradient's reduction and ZeRO-1's gather
        assert rec["collectives"]["all-reduce"] > 0
        assert rec["collective_calls"]["zero1_gather"] > 0
    else:
        # the placed step: row-parallel sums and the vocabulary's slices
        # joined (a (2 × 2) mesh splits both models' matrices)
        assert rec["collective_calls"]["all_sum"] > 0
        assert rec["collective_calls"]["concat"] > 0
        assert rec["compute_s"] == rec["flops_per_chip"] / 989e12
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert 0 < rec["step_time_s"] and 0 < rec["roofline_fraction"]
        args = [S.param_specs(cfg, mesh, quant),
                S.cache_specs(cfg, mesh, c.global_batch, c.seq_len)]
        args.append(S.batch_specs(cfg, c, mesh) if step == "prefill"
                    else dict(enumerate(S.decode_token_specs(
                        mesh, c.global_batch))))
        want = S.shard_bytes(*args)
    assert mem["argument_bytes"] == want
    assert rec["collective_bytes_per_chip"] == rec["collectives"]["total"]
    assert rec["collective_s"] == rec["collectives"]["total"] / 450e9
    assert rec["collectives"]["total"] == sum(
        v for k, v in rec["collectives"].items() if k != "total")
    # the analytic terms and MODEL_FLOPS are the reference's
    n = rconfigs.get_config(arch).n_active_params()
    assert cfg.n_active_params() == n
    tokens = c.global_batch * (c.seq_len if step != "decode" else 1)
    assert rec["model_flops_global"] == (6.0 if step == "train" else 2.0) \
        * n * tokens
    assert rec["flops_per_chip"] == rec["analytic_flops_global"] / 4
    written = json.loads((tmp_path / f"{arch}__{cell}__single__"
                          f"{rec['quant']}.json").read_text())
    assert written == json.loads(json.dumps(rec))


def test_decode_cell_bytes_hand_count_on_a_2x2_mesh():
    """Qwen2.5-0.5B's decode_32k cell (f32 params, B 128, S 32,768) on a
    (2 × 2) mesh, counted by hand: a device holds half of every matrix,
    bias and the vocabulary (the norms whole), half the batch's rows of
    a cache striped along S over ``model`` (bf16 k / v, 24 layers), and
    its rows' token and position; the placed step runs the first
    replica's 64 rows, so its logits are [64, V] f32 (the fused-sample
    variant's, [64] int32 tokens). Its collectives a device: the
    embedding's vocab-parallel pieces summed (f32 [64, D]); per layer the
    q heads' stripes joined (bf16 [64, 7, 64]: 7 of 14 heads a shard) and
    k's and v's (bf16 [64, 1, 64]: 1 of 2 kv heads), each S stripe's
    partial max, sum and output joined (f32: ``meta`` reads as the CPU's
    f32), the combined output cut for the row-parallel ``wo`` (bf16
    [64, D / 2]), ``wo``'s and ``down``'s partials summed (f32 [64, D]);
    the head's vocabulary slices joined (f32 [64, V / 2]), or each
    shard's [64] maximum and index."""
    d, kvd, f, v, n_l = 896, 128, 4864, 151936, 24
    rows, s_stripe = 128 // 2, 32768 // 2
    params = 4 * ((v * d + n_l * (2 * kvd + 2 * d * kvd + 2 * d * d + d
                                  + 3 * d * f)) // 2 + d + 2 * n_l * d)
    cache = n_l * 2 * rows * s_stripe * 2 * 64 * 2
    rec = dryrun.run_cell("qwen25-05b", "decode_32k", "single", False, None,
                          mesh=_mesh(2, 2))
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] == params + cache + 2 * rows * 4
    assert mem["output_bytes"] == cache + rows * v * 4
    layer = {"concat": rows * 7 * 64 * 2 + 2 * rows * 64 * 2
             + 2 * rows * 14 * 4 + rows * 14 * 64 * 4,
             "split": rows * d // 2 * 2, "all_sum": 2 * rows * d * 4}
    want = {"all_sum": rows * d * 4 + n_l * layer["all_sum"],
            "concat": n_l * layer["concat"] + rows * v // 2 * 4,
            "split": n_l * layer["split"]}
    assert rec["collective_calls"] == {"all_sum": 1 + 2 * n_l,
                                       "concat": 6 * n_l + 1,
                                       "split": n_l}
    assert rec["collectives"]["all-reduce"] == want["all_sum"]
    assert rec["collectives"]["all-gather"] == want["concat"]
    assert rec["collectives"]["scatter"] == want["split"]
    assert rec["collectives"]["total"] == sum(want.values())
    fused = dryrun.run_cell("qwen25-05b", "decode_32k", "single", False,
                            None, variant="fused-sample", mesh=_mesh(2, 2))
    assert fused["memory_analysis"]["output_bytes"] == cache + rows * 4
    assert fused["memory_analysis"]["argument_bytes"] == \
        mem["argument_bytes"]
    assert fused["collectives"]["all-gather"] == \
        n_l * layer["concat"] + 2 * rows * 4


@pytest.mark.parametrize("arch,cell,quant", [
    ("deepseek-v2-lite-16b", "train_4k", False),
    ("deepseek-v2-lite-16b", "prefill_32k", False),
    ("deepseek-v2-lite-16b", "decode_32k", False),
    ("qwen2-moe-a2.7b", "decode_32k", False),
    ("mamba2-130m", "prefill_32k", True),
    ("mamba2-130m", "long_500k", True),
    ("hymba-1.5b", "prefill_32k", True),
    ("hymba-1.5b", "decode_32k", True),
    ("hubert-xlarge", "prefill_32k", True),
    ("phi-3-vision-4.2b", "prefill_32k", True),
    ("phi-3-vision-4.2b", "decode_32k", True),
    ("gemma3-4b", "long_500k", True),
    ("glm4-9b", "decode_32k", True)])
def test_every_family_runs_on_meta(arch, cell, quant):
    """Every family's cells on a (1 × 4) mesh: MoE + MLA train, and each
    family's placed prefill and decode (the MoE models with float experts:
    the packed experts' plain path loops over 64 experts, a minute on
    ``meta``); each counts its collectives, the row-parallel sums among
    them."""
    mesh = _mesh(1, 4)
    rec = dryrun.run_cell(arch, cell, "single", quant, None, mesh=mesh)
    assert rec["chips"] == 4 and rec["memory_analysis"][
        "argument_bytes"] > 0, arch
    assert rec["collectives"]["total"] > 0
    assert rec["collective_calls"]["all_sum"] >= 1
    assert rec["step_time_s"] > 0


def test_main_exits_1_on_a_failing_cell(monkeypatch, tmp_path, capsys):
    calls = []

    def fake(arch, cell, mk, quant, out, variant):
        calls.append((arch, cell, mk, quant))
        if cell == "prefill_32k":
            raise RuntimeError("boom")
        return {}
    monkeypatch.setattr(dryrun, "run_cell", fake)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert len(calls) == 2 * sum(len(configs.cells_for(a))
                                 for a in configs.list_archs()) == 70
    assert all(q == (configs.SHAPES[c].step != "train")
               for _, c, _, q in calls)
    assert "FAILED cells" in capsys.readouterr().out


def test_roofline_terms_are_the_references_at_h100_constants(monkeypatch):
    args = (3.1e12, 2.2e9, 5.0e8, 256, 1.7e15)
    got = analysis.roofline_terms(*args)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    for name, val in (("PEAK_FLOPS", 989e12), ("HBM_BW", 3.35e12),
                      ("ICI_BW", 450e9)):
        monkeypatch.setattr(ranalysis, name, val)
    want = ranalysis.roofline_terms(*args)
    assert got.to_dict() == want.to_dict()
    assert got.compute_s == 3.1e12 / 989e12
    assert analysis.RooflineTerms(0, 0, 0, 1).roofline_fraction == 0.0


def _tp_model():
    cfg = dataclasses.replace(qwen25_05b.smoke_config(), num_heads=8,
                              num_kv_heads=4, head_dim=16)
    m = Model(cfg)
    return m, m.init(torch.Generator().manual_seed(0), device="cpu")


def test_counter_hand_count_serve_step():
    """A (1 × 2) chunk step of B 2 × C 4 over bf16 pools, f32 params: the
    embedding's vocab-parallel pieces summed (f32 [B, C, D]), each layer's
    wo and down partials summed (f64 on the CPU), the head's vocab slices
    joined (f32 [B, 1, V / 2]); nothing is counted outside the block."""
    m, p = _tp_model()
    cfg = m.cfg
    mesh = shd.serving_mesh(2, devices=["cpu"] * 2)
    sp = shd.shard_params(p, mesh, cfg)
    pools = m.init_paged_cache(9, 4, mesh=mesh)
    b, c, d = 2, 4, cfg.d_model
    toks = torch.arange(b * c, dtype=torch.int32).reshape(b, c)
    pos = torch.arange(c, dtype=torch.int32)[None].repeat(b, 1)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    sidx = torch.full((b,), c - 1, dtype=torch.int32)
    with torch.no_grad(), analysis.count_collectives() as n:
        m.chunk_step(sp, pools, toks, pos, sidx, page_table=table,
                     mesh=mesh)
    L = cfg.num_layers
    assert n.calls == {"all_sum": 1 + 2 * L, "concat": 1}
    assert n.by_op == {"all_sum": b * c * d * 4 + 2 * L * b * c * d * 8,
                       "concat": b * (cfg.vocab_size // 2) * 4}
    costs = analysis.collective_costs(n)
    assert costs["all-reduce"] == n.by_op["all_sum"]
    assert costs["all-gather"] == n.by_op["concat"]
    assert costs["total"] == n.total
    with torch.no_grad():
        m.chunk_step(sp, pools, toks, pos, sidx, page_table=table,
                     mesh=mesh)
    assert n.calls == {"all_sum": 1 + 2 * L, "concat": 1}


def test_counter_hand_count_train_step():
    """A (2 × 2) train step, B 4 × S 8: a replica's forward (its rows B/2:
    the embedding's sum in bf16, per layer wo's and down's f64 partial
    sums, the head's slices joined, f32 [B/2, S, V/2]; each of the two
    replicas' calls a half); every leaf's gradient on the
    first device reduced over ``data`` in bf16 (its model stripe, a
    replicated leaf whole); ZeRO-1's gather of the first device's f32
    slice of every leaf that has a ZeRO-1 dim."""
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state
    # without remat, whose recomputation in the backward runs the blocks'
    # collectives again where autograd asks for them
    m = Model(dataclasses.replace(_tp_model()[0].cfg, remat=False))
    cfg = m.cfg
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    sh = shd.TrainSharding(mesh, cfg)
    state = sh.place(init_train_state(m, torch.Generator().manual_seed(0),
                                      device="cpu"))
    step = make_train_step(m, TrainConfig(), mesh=mesh)
    b, s, d = 4, 8, cfg.d_model
    batch = {"tokens": torch.arange(b * s, dtype=torch.int32).reshape(b, s),
             "labels": torch.ones((b, s), dtype=torch.int32)}
    with analysis.count_collectives() as n:
        step(state, batch)
    L = cfg.num_layers
    rows = b // 2 * s
    specs = sh.specs(init_train_state(m, torch.Generator().manual_seed(0),
                                      device="meta")["params"])
    params = init_train_state(m, torch.Generator().manual_seed(0),
                              device="meta")["params"]
    grad, zero = 0, 0
    from repro_torch.utils.tree import layer_parts
    for (_, sparts, sleaf), (_, pparts, pleaf) in zip(layer_parts(specs),
                                                      layer_parts(params)):
        for (mdim, ddim), t in zip(sparts or [sleaf], pparts or [pleaf]):
            numel = t.numel() // (2 if mdim is not None else 1)
            grad += numel * 2                       # bf16 on the wire
            if ddim is not None:
                zero += numel // 2 * 4              # f32 slice
    assert n.calls["all_sum"] == 1 + 2 * L and n.calls["concat"] == 1
    # the step casts the f32 matrices to bf16 first: the table's rows too
    assert n.by_op["all_sum"] == rows * d * 2 + 2 * L * rows * d * 8
    assert n.by_op["concat"] == rows * (cfg.vocab_size // 2) * 4
    assert n.by_op["grad_reduce"] == grad
    assert n.by_op["zero1_gather"] == zero
    assert set(n.by_op) == {"all_sum", "concat", "grad_reduce",
                            "zero1_gather"}
    assert math.isclose(analysis.collective_costs(n)["total"], n.total)


def test_dryrun_parameter_bytes_match_placed_bytes():
    """The dry run's bytes a device of a smoke-size Qwen2.5 variant's AWQ
    params on a (1 × 2) mesh (`param_specs`) against what `shard_params`
    stores a shard on the CPU: equal, a packed linear's bias (which the
    rule replicates, as the reference's) a view of the shard's own whole
    copy (`chip_smoke.py`'s `dryrun` phase holds the card's allocator to
    the same bytes at full size)."""
    from repro_torch.core.pipeline import quantize_params
    from repro_torch.utils.tree import layer_parts
    cfg = dataclasses.replace(qwen25_05b.smoke_config(), d_model=256,
                              num_heads=4, num_kv_heads=2, head_dim=64,
                              d_ff=512)
    m = Model(cfg)
    params = quantize_params(m.init(torch.Generator().manual_seed(0),
                                    device="cpu"))[0]
    mesh = shd.serving_mesh(2, devices=["cpu"] * 2)
    want = S.shard_bytes(S.param_specs(cfg, mesh, True))
    for shard in shd.shard_params(params, mesh, cfg):
        storages = {}
        for _, parts, leaf in layer_parts(shard):
            for t in parts if parts is not None else [leaf]:
                storages[t.untyped_storage().data_ptr()] = \
                    t.untyped_storage().nbytes()
        assert sum(storages.values()) == want
