"""Dry run: every (arch × shape cell × mesh) step over ``meta`` tensors.

The reference lowers and compiles each cell with XLA over 512 placeholder
devices and reads the compiled program's memory, cost and collectives
(`repro/launch/dryrun.py`). The port has no compiler to ask, so it runs
the step itself, eagerly, with every tensor on PyTorch's ``meta`` device
(shapes and dtypes, no storage: nothing allocates, a 9B-param model at
32k context included) on the reference's production mesh of ``meta``
devices (`launch.mesh.make_production_mesh`: ``(data, model)`` 16 × 16,
or ``(pod, data, model)`` 2 × 16 × 16):

  * train cells: the train state placed over the mesh (`TrainSharding`:
    params by `param_pspec`, ZeRO-1 moments) and one train step
    (`make_train_step(mesh=)`: the batch over the data replicas, each
    replica's forward and backward over its ``model`` shards, the
    gradient reduced over ``data``, AdamW on the ZeRO-1 slices);
  * prefill cells: the placed `Model.prefill(mesh=)` of the first data
    replica's rows: its parameters placed over its ``model`` shards by
    `param_pspec` (`shard_params`) and its decode cache by `cache_pspec`
    (`place_cache`: k / v along S, or over kv heads where S cannot
    stripe; MLA's latents along S; conv caches over channels, SSM states
    over heads), each block's column- and row-parallel linears, the
    vocabulary-parallel head;
  * decode cells: the placed `Model.decode_step(mesh=)` over that cache
    (each S stripe's partial softmax on its shard, combined in shard
    order); with ``--variant fused-sample`` the step returns each row's
    greedy token instead of its logits (each shard's argmax of its vocab
    slice, the ``[B]`` maxima and indices gathered), as the reference's
    fused-sample step does. ``kvint8`` variants store k / v as int8.

The reference runs every data replica's rows (GSPMD replicates the
weights over ``data``); the port runs the first replica's, whose
collectives a device takes part in are those of every replica.

The kernel wrappers take their plain versions on ``meta`` (no CUDA
launch); the quantized linears the generic path. Each cell writes one
JSON record with the reference's keys:

  * ``memory_analysis.argument_bytes``: the largest device's bytes of the
    step's inputs by the rules (`launch.specs`: `param_specs`,
    `train_state_specs`, `cache_specs`, `batch_specs`,
    `decode_token_specs`); ``output_bytes``: the outputs' (a train
    step's new state by the same rules; a prefill's or decode step's
    cache by its rule, plus what the placed step returns whole on the
    first device: the logits and next positions, or a fused-sample
    step's int32 tokens);
  * ``collectives`` / ``collective_bytes_per_chip``: the operand bytes a
    device of the step's explicit collectives, counted while it runs
    (`roofline.analysis.count_collectives`), and ``collective_calls``
    their calls by collective;
  * the analytic terms (`roofline.costmodel.analytic_terms`) and
    `model_flops_estimate`, the reference's; the roofline terms
    (`roofline.analysis.RooflineTerms` at the H100's constants) take the
    analytic FLOPs and bytes a chip and the counted collective bytes;
  * keys XLA fills and eager PyTorch has nothing for are ``null``:
    ``compile_s``, ``memory_analysis.temp_bytes`` / ``code_bytes``,
    ``hlo_flops``, ``hlo_bytes_upper_bound``, ``raw_cost_analysis``.
    ``lower_s`` is the time to build the cell's inputs, ``run_s`` (a key
    of the port's) the meta step's.

A cell that fails is reported and the run exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --cell train_4k --mesh single --quant awq --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, cells_for
from repro_torch.core import qlinear
from repro_torch.distributed.sharding import (TrainSharding, param_pspec,
                                              place_cache, replica_meshes,
                                              shard_params)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.roofline.analysis import (RooflineTerms, collective_costs,
                                           count_collectives)
from repro_torch.roofline.costmodel import analytic_terms
from repro_torch.training import TrainConfig, make_train_step
from repro_torch.training.train_step import train_state_shapes

META = torch.device("meta")


def model_flops_estimate(cfg, cell) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D (train) or 2·N_active·D (decode/
    prefill forward-only), D = tokens processed this step."""
    n = cfg.n_active_params()
    if cell.step == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.step == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


def meta_mesh(kind: str):
    """The reference's production mesh over ``meta`` devices."""
    multi = kind == "multi"
    return make_production_mesh(multi_pod=multi,
                                devices=[META] * (512 if multi else 256))


def _inputs(leaves: dict) -> dict:
    return {k: v.meta for k, v in leaves.items()}


def _whole_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_step(arch: str, cell_name: str, mesh, quant: bool,
             variant: str = "baseline") -> dict:
    """Build one cell's inputs and run its step once over ``meta``
    tensors → the record's measured part (input / output bytes a device,
    times, and the step's collective counter)."""
    cfg = configs.get_config(arch)
    if "kvint8" in variant:
        cfg = dataclasses.replace(cfg, kv_quant="int8")
    cell = SHAPES[cell_name]
    model = Model(cfg)
    t0 = time.time()
    with qlinear.execution_config(qlinear.ExecutionConfig(impl="ref")):
        if cell.step == "train":
            state_specs = S.train_state_specs(cfg, mesh)
            batch = S.batch_specs(cfg, cell, mesh)
            state = TrainSharding(mesh, cfg).place(train_state_shapes(model))
            step = make_train_step(model, TrainConfig(), mesh=mesh)
            args = (state_specs, batch)
            out_bytes = S.shard_bytes(state_specs)
            t_lower = time.time() - t0
            t0 = time.time()
            with count_collectives() as counter:
                step(state, _inputs(batch))
            return dict(cfg=cfg, cell=cell, lower_s=t_lower,
                        run_s=time.time() - t0,
                        argument_bytes=S.shard_bytes(*args),
                        output_bytes=out_bytes, counter=counter)
        params = S._param_tree(cfg, quant)
        p_specs = S.leaf_specs(params, mesh, param_pspec, cfg)
        c_specs = S.cache_specs(cfg, mesh, cell.global_batch, cell.seq_len)
        if cell.step == "prefill":
            batch = S.batch_specs(cfg, cell, mesh)
            args = (p_specs, batch, c_specs)
        else:
            tok, pos = S.decode_token_specs(mesh, cell.global_batch)
            batch = {"token": tok, "pos": pos}
            args = (p_specs, c_specs, batch)
        # the first data replica's rows (the whole batch where the rule
        # replicates it), its params and cache placed over its shards
        first = replica_meshes(mesh)[0]
        rows = next(iter(batch.values())).shard_shape()[0]
        local = {k: v.meta[:rows] for k, v in batch.items()}
        shards = shard_params(params, first, cfg)
        cache = place_cache(model.init_cache(rows, cell.seq_len,
                                             device=META), first)
        t_lower = time.time() - t0
        t0 = time.time()
        with torch.no_grad(), count_collectives() as counter:
            if cell.step == "prefill":
                _, logits, nxt = model.prefill(shards, local, cache,
                                               mesh=first)
                returned = (logits, nxt)
            else:
                returned = (model.decode_step(
                    shards, cache, local["token"], local["pos"], mesh=first,
                    greedy=variant == "fused-sample")[0],)
        out_bytes = S.shard_bytes(c_specs) + _whole_bytes(*returned)
    return dict(cfg=cfg, cell=cell, lower_s=t_lower,
                run_s=time.time() - t0, argument_bytes=S.shard_bytes(*args),
                output_bytes=out_bytes, counter=counter)


def run_cell(arch: str, cell_name: str, mesh_kind: str, quant: bool,
             out_dir: str | None, variant: str = "baseline",
             mesh=None) -> dict:
    """One cell's record (printed; written under ``out_dir`` when given).
    ``mesh`` overrides the production mesh of ``mesh_kind`` (tests)."""
    mesh = meta_mesh(mesh_kind) if mesh is None else mesh
    chips = mesh.devices.size
    got = run_step(arch, cell_name, mesh, quant, variant)
    cfg, cell = got["cfg"], got["cell"]
    counter = got["counter"]
    costs = collective_costs(counter)
    analytic = analytic_terms(cfg, cell_name, chips, quant)
    terms = RooflineTerms(
        flops=analytic["analytic_flops_global"] / chips,
        bytes_accessed=analytic["analytic_bytes_global"] / chips,
        collective_bytes=costs["total"], chips=chips,
        model_flops=model_flops_estimate(cfg, cell))
    roofline = terms.to_dict()
    rec = {
        "arch": arch, "cell": cell_name, "mesh": mesh_kind,
        "variant": variant,
        "chips": chips, "quant": "awq-int4" if quant else "none",
        "step": cell.step,
        "lower_s": round(got["lower_s"], 2), "compile_s": None,
        "run_s": round(got["run_s"], 2),
        "memory_analysis": {
            "argument_bytes": int(got["argument_bytes"]),
            "output_bytes": int(got["output_bytes"]),
            "temp_bytes": None,
            "code_bytes": None,
        },
        "collectives": costs,
        "collective_calls": dict(counter.calls),
        "hlo_flops": None,
        "hlo_bytes_upper_bound": None,
        "raw_cost_analysis": None,
        **analytic,
        **roofline,
    }
    print(f"[dryrun] {arch} {cell_name} mesh={mesh_kind} "
          f"quant={rec['quant']}")
    print(f"  memory_analysis: {rec['memory_analysis']}")
    print(f"  cost: flops/chip={terms.flops:.3e} bytes/chip="
          f"{terms.bytes_accessed:.3e} coll_bytes/chip="
          f"{terms.collective_bytes:.3e}")
    print(f"  terms: compute={terms.compute_s:.3e}s memory="
          f"{terms.memory_s:.3e}s collective={terms.collective_s:.3e}s "
          f"dominant={terms.dominant} roofline_frac="
          f"{terms.roofline_fraction:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{cell_name}__{mesh_kind}__{rec['quant']}"
        if variant != "baseline":
            fn += f"__{variant}"
        fn += ".json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="awq", choices=["awq", "none"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    jobs = []
    if args.all:
        for arch in configs.list_archs():
            for cell in cells_for(arch):
                for mk in meshes:
                    jobs.append((arch, cell, mk))
    else:
        for mk in meshes:
            jobs.append((args.arch, args.cell, mk))

    failures = []
    t0 = time.time()
    for arch, cell, mk in jobs:
        quant = (args.quant == "awq") and SHAPES[cell].step != "train"
        try:
            run_cell(arch, cell, mk, quant, args.out, args.variant)
        except Exception as e:  # a failing cell is a bug in the system
            failures.append((arch, cell, mk, repr(e)))
            traceback.print_exc()
    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print(f"dry-run OK: {len(jobs)} cells in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
