"""Training launcher: the train loop with fault tolerance (the reference's
`launch/train.py`).

  * the train step (`training.make_train_step`: bf16 gradient casts,
    AdamW, per-block remat; attention's gradient through kernel K4b),
    over a ``(data, model)`` mesh with ``--data-axis`` / ``--model-axis``
    (`launch.mesh.make_host_mesh`; ZeRO-1 moments, the gradient reduced
    over ``data`` in replica order; `distributed.sharding.TrainSharding`),
  * async atomic checkpointing in the reference's file format + exact
    resume (pure-function data pipeline),
  * node-failure recovery: any step exception waits for the saves in
    flight, reloads the latest checkpoint and continues
    (``--simulate-failure-at`` injects one),
  * straggler watchdog: per-step wall-clock vs running median; slow
    steps are logged for an external scheduler to re-dispatch.

``--arch`` takes every registered config, as the reference's does:
dense decoders, MoE (qwen2-moe-a2.7b; deepseek-v2-lite-16b with MLA),
SSM (mamba2-130m), hybrid (hymba-1.5b), the audio encoder
(hubert-xlarge: stub frames, codeword labels) and the VLM
(phi-3-vision-4.2b: stub patches, labels over the text). Both axes
take every family (the batch must divide over ``data``; each leaf splits
over ``model`` as the reference's `param_pspec` splits it). The mesh's
shards lie on this machine's cards (``--device cuda``, one a shard), or
all on one device: ``--device cpu`` or a card by index (``--device
cuda:0``).
Checkpoints hold the logical state, so a run resumes on any mesh. Returns
``{"first_loss", "last_loss", "steps"}`` as the reference's does, plus
``recoveries`` (failures recovered), ``losses`` and ``step_s`` (each
completed step's loss and synchronized wall time, in order; a step
redone after a recovery appears again).

Usage (the card is the default device; ``--device cpu`` runs the plain
paths):
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 12 --batch 4 --seq 32 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen25-05b \\
      --steps 100 --batch 8 --seq 512 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --arch hubert-xlarge --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --data-axis 2 --model-axis 2 --steps 4 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --arch mamba2-130m --model-axis 2 --steps 2
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data.pipeline import make_dataset
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import TrainSharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.train_step import (init_train_state,
                                             train_state_shapes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen25-05b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch paths)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = Model(cfg)
    sharding = None
    if args.data_axis > 1 or args.model_axis > 1:
        if args.batch % args.data_axis:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"--data-axis {args.data_axis}")
        n = args.data_axis * args.model_axis
        shared = device.type != "cuda" or device.index is not None
        sharding = TrainSharding(make_host_mesh(
            args.data_axis, args.model_axis,
            devices=[device] * n if shared else None), cfg)
        device = sharding.mesh.devices.flat[0]
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=args.lr, warmup_steps=args.warmup, decay_steps=args.steps,
        weight_decay=0.0))
    ds = make_dataset(cfg, args.batch, args.seq, args.seed)
    step_fn = make_train_step(model, tcfg,
                              mesh=sharding and sharding.mesh)

    def fresh_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_train_state(model, gen, device=device)
        return state if sharding is None else sharding.place(state)

    state = fresh_state()
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if latest_step(args.ckpt_dir) is not None:
            state, start = restore(args.ckpt_dir, train_state_shapes(model),
                                   device=device, shardings=sharding)
            print(f"[train] resumed from step {start}")

    losses, times = [], []
    i = start
    failed_once = False
    recoveries = 0
    while i < args.steps:
        batch = ds.batch_at(i)
        t0 = time.time()
        try:
            if i == args.simulate_failure_at and not failed_once:
                failed_once = True
                raise RuntimeError("simulated node failure")
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as e:  # node-failure path: reload + retry
            print(f"[train] step {i} failed ({e}); recovering from "
                  "latest checkpoint")
            recoveries += 1
            if ckpt is not None:
                # let in-flight saves land first: the reference reads
                # LATEST before waiting, and restarts from step 0 when a
                # save is still being written
                ckpt.wait()
            if ckpt is None or latest_step(args.ckpt_dir) is None:
                state = fresh_state()
                i = 0
            else:
                state = None              # free the device copy first
                state, i = restore(args.ckpt_dir, train_state_shapes(model),
                                   device=device, shardings=sharding)
            continue
        dt = time.time() - t0
        times.append(dt)
        if len(times) >= 5:
            med = statistics.median(times[-50:])
            if dt > args.straggler_factor * med:
                print(f"[train] STRAGGLER step {i}: {dt:.3f}s vs median "
                      f"{med:.3f}s — flagged for re-dispatch")
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0:
            print(f"[train] step {i} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms")
        i += 1
        if ckpt and (i % args.ckpt_every == 0 or i == args.steps):
            ckpt.save(i, state)
    if ckpt:
        ckpt.close()
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} → {losses[-1]:.4f}")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": len(losses), "recoveries": recoveries, "losses": losses,
            "step_s": times}


if __name__ == "__main__":
    main()
