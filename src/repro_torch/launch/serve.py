"""Serving launcher: AWQ-quantize a model and serve a static batch or a fleet.

The end-to-end path of the paper (§III-A "fully automated"), as the
reference's classic launcher runs it: float init → calibration forward
(`Model.loss` under `CalibrationCapture`; attention through kernel K4) →
AWQ search + int4 GS-64 pack of every quantizable linear →
`GenerationEngine.generate` (prefill through K4, projections through
K1, each GLU front through K3). ``--quant none`` serves the float model through the same
`generate()`. A vision model (phi-3-vision) calibrates on tokens plus
stub patch embeddings and then generates from text prompts, as the
reference's launcher does. An encoder (hubert-xlarge) calibrates on stub
frame features, quantizes and packs, and ends there: it has no decode
step (its serving output is `Model.prefill`'s logits at every frame), so
the launcher prints that and returns the quantization report (the
reference's launcher goes on to a token prompt and fails on the
features batch).

With ``--replicas N`` the launcher serves a continuous-batching
**fleet** instead (`serve_fleet`): N `GenerationEngine` replicas (or,
with ``--disagg``, `DisaggController` prefill/decode pairs) sharing the
one params tree, each engine with its own page pools, behind the
prefix-affinity `serving.router.Router`, built from
`launch.specs.FleetSpec`. ``--mesh-axis N`` > 1 serves each replica
(each side of a pair) tensor-parallel over N shards: N cards, or, with
``--device cpu``, N shards sharing the CPU; the model's KV heads must
divide N (the qwen25-05b smoke config has one: take ``--arch glm4-9b``).
Without ``--replicas`` the fleet flags are ignored, as the reference
ignores them.

Usage (the card is the default device; ``--device cpu`` runs the plain
paths):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen25-05b \\
      --quant awq --batch 4 --prompt-len 256 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen25-05b \\
      --quant awq --replicas 2 --mesh-axis 1 --batch 4 --prompt-len 256 \\
      --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --replicas 2 [--disagg]
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --arch glm4-9b --replicas 2 --mesh-axis 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hubert-xlarge \\
      --quant awq
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi-3-vision-4.2b --quant awq --batch 2 --prompt-len 256
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.awq import AWQConfig
from repro_torch.core.calibration import CalibrationCapture
from repro_torch.core.pipeline import model_size_bytes, quantize_params
from repro_torch.core.quantize import QuantConfig
from repro_torch.data.pipeline import make_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import awq_matmul as k1
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import paged_attention as k2
from repro_torch.launch.specs import FleetSpec, ReplicaSpec
from repro_torch.models.model import Model
from repro_torch.serving.engine import GenerationEngine, SamplerConfig


def _launches() -> dict:
    return {"flash_attention": k4.COUNTER.count,
            "awq_matmul": k1.COUNTER.count,
            "awq_gateup": k1.GATEUP_COUNTER.count,
            "paged_attention_chunk": k2.COUNTER.count}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen25-05b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="awq", choices=["awq", "none"])
    ap.add_argument("--group-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain paths)")
    # fleet flags (scale + replica template + drain budget)
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve a Router fleet of N replicas instead of "
                         "one static-batch engine (0 = classic path)")
    ap.add_argument("--mesh-axis", type=int, default=1,
                    help="per-replica tensor-parallel width (that many "
                         "cards; shards share the CPU with --device cpu)")
    ap.add_argument("--disagg", action="store_true",
                    help="each replica is a prefill/decode engine pair")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="drain_replica step budget (seconds) for elastic "
                         "scale-down")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        device=device)
    fp16_bytes = model_size_bytes(params, quantized=False)
    print(f"[serve] {cfg.name}: fp16-serialized size "
          f"{fp16_bytes/1e6:.2f} MB")

    res: dict = {"report": None, "fp16_bytes": fp16_bytes, "launches": {}}
    if args.quant == "awq":
        ds = make_dataset(cfg, 2, min(64, cfg.max_seq_len), seed=123)
        calib = {k: torch.as_tensor(v, device=device)
                 for k, v in ds.batch_at(0).items()}
        _sync(device)
        before = _launches()
        t0 = time.perf_counter()
        with CalibrationCapture() as cap, torch.no_grad():
            model.loss(params, calib)
        _sync(device)
        t1 = time.perf_counter()
        res["launches"]["calibrate"] = _since(before)
        qcfg = AWQConfig(quant=QuantConfig(group_size=args.group_size))
        params, report = quantize_params(params, cap.stats, qcfg)
        _sync(device)
        t2 = time.perf_counter()
        print(f"[serve] AWQ PTQ in {t2 - t0:.1f}s: "
              f"{len(report.quantized)} linears quantized "
              f"({len(report.calibrated)} calibrated), "
              f"{len(report.skipped)} kept FP")
        macro_bytes = model_size_bytes(params, quantized=True)
        print(f"[serve] AWQ_MACRO-serialized size {macro_bytes/1e6:.2f} MB")
        res.update(report=report, calib_s=t1 - t0, awq_s=t2 - t1,
                   macro_bytes=macro_bytes, captured_linears=len(cap.stats))

    if cfg.is_encoder:
        print(f"[serve] {cfg.name} is encoder-only: no autoregressive "
              f"decode step (serve it through Model.prefill / "
              f"forward_logits)")
        return {"params": params, **res}

    if args.replicas > 0:
        fleet = serve_fleet(model, params, args, device)
        res["launches"].update(fleet.pop("launches"))
        return {**fleet, "params": params, **res}

    engine = GenerationEngine(
        model, params, max_seq=args.prompt_len + args.max_new,
        sampler=SamplerConfig(temperature=args.temperature))
    ds = make_dataset(cfg, args.batch, args.prompt_len, seed=args.seed)
    prompt = {"tokens": ds.batch_at(0)["tokens"]}

    _sync(device)
    before = _launches()
    t0 = time.perf_counter()
    out = engine.generate(prompt, args.max_new,
                          gen=torch.Generator(device=device).manual_seed(
                              args.seed))
    _sync(device)
    dt = time.perf_counter() - t0
    res["launches"]["generate"] = _since(before)
    tput = out.size / dt
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] generated {out.shape} tokens in {dt:.2f}s "
          f"({tput:.1f} tok/s wall on {where})")
    print(f"[serve] sample: {out[0][:16].tolist()}")
    return {"tokens_per_s": tput, "shape": list(out.shape),
            "generate_s": dt, "tokens": out, "params": params, **res}


def serve_fleet(model, params, args, device: torch.device) -> dict:
    """Continuous-batching fleet: FleetSpec → Router → clustered burst.

    The burst shares one system prefix per cluster so the router's
    prefix-affinity scoring has something to aim at: each cluster's
    prefix is pinned (sticky) and warmed by one request first. Returns
    the reference's report (tokens/s, requests, prefill tokens skipped,
    replicas) plus the placement ledger, the streams and the kernel
    launches of the warm-up + burst.
    """
    cfg = model.cfg
    max_seq = args.prompt_len + args.max_new
    page = 8
    spec = FleetSpec(
        replicas=args.replicas,
        replica=ReplicaSpec(
            mesh_axis=args.mesh_axis, disagg=args.disagg,
            prefill_mesh_axis=args.mesh_axis,
            decode_mesh_axis=args.mesh_axis,
            engine_kwargs=dict(max_seq=max_seq, num_slots=args.batch,
                               page_size=page, prefill_chunk=page)),
        drain_timeout_s=args.drain_timeout)
    print(f"[serve] fleet: {spec.replicas} replica(s), mesh_axis="
          f"{args.mesh_axis}, disagg={args.disagg}, "
          f"drain_timeout={spec.drain_timeout_s:.0f}s")
    _sync(device)
    before = _launches()
    router = spec.build(model, params)
    router.warmup()

    rng = np.random.default_rng(args.seed)
    n_clusters = 2
    prefixes = [rng.integers(0, cfg.vocab_size, (args.prompt_len - 4,)
                             ).astype(np.int32) for _ in range(n_clusters)]
    # pin first (sticky), then warm one request per cluster so the burst
    # below has resident prefixes to route toward
    for c in range(n_clusters):
        router.pin_prefix(f"sys{c}")
        router.submit(np.concatenate(
            [prefixes[c],
             rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)]),
            2, prefix_id=f"sys{c}")
    router.drain()
    n_req = max(args.batch * args.replicas, 4)
    rids = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(n_req):
        c = i % n_clusters
        tail = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
        rids.append(router.submit(
            np.concatenate([prefixes[c], tail]), args.max_new,
            sampler=SamplerConfig(temperature=args.temperature),
            prefix_id=f"sys{c}", session_id=f"user{i % (2 * n_clusters)}"))
    out = router.drain()
    _sync(device)
    dt = time.perf_counter() - t0
    useful = sum(len(out[r]) for r in rids)
    tput = useful / dt
    # a DisaggController replica reports `DisaggStats`, which has no
    # prefill_tokens_skipped: it counts 0, as in the reference's report
    skipped = sum(getattr(s, "prefill_tokens_skipped", 0)
                  for s in router.stats())
    rs = router.router_stats
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] fleet served {n_req} requests / {useful} tokens in "
          f"{dt:.2f}s ({tput:.1f} tok/s wall on {where})")
    print(f"[serve] placement: {rs.placements} scored, "
          f"{rs.affinity_hits} affinity hits, "
          f"{rs.session_hits} session hits, "
          f"{skipped} prefill tokens skipped fleet-wide")
    return {"tokens_per_s": tput, "requests": n_req,
            "prefill_tokens_skipped": int(skipped),
            "replicas": args.replicas, "fleet_s": dt,
            "placements": rs.placements, "affinity_hits": rs.affinity_hits,
            "session_hits": rs.session_hits,
            "streams": [out[r] for r in rids],
            "launches": {"fleet": _since(before)}}


if __name__ == "__main__":
    main()
