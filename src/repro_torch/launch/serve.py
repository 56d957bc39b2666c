"""Serving launcher: AWQ-quantize a model and generate for a static batch.

The end-to-end path of the paper (§III-A "fully automated"), as the
reference's classic launcher runs it: float init → calibration forward
(`Model.loss` under `CalibrationCapture`; attention through kernel K4) →
AWQ search + int4 GS-64 pack of every quantizable linear →
`GenerationEngine.generate` (prefill through K4, decode projections
through K1). ``--quant none`` serves the float model through the same
`generate()`. The fleet flags (``--replicas``, ``--mesh-axis``,
``--disagg``, ``--drain-timeout``) are not ported yet and raise.

Usage (the card is the default device; ``--device cpu`` runs the plain
paths):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen25-05b \\
      --quant awq --batch 4 --prompt-len 256 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

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
from repro_torch.models.model import Model
from repro_torch.serving.engine import GenerationEngine, SamplerConfig

FLEET_DEFAULTS = {"replicas": 0, "mesh_axis": 1, "disagg": False,
                  "drain_timeout": 30.0}


def _launches() -> dict:
    return {"flash_attention": k4.COUNTER.count,
            "awq_matmul": k1.COUNTER.count}


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
    # the reference's fleet flags: accepted, refused until the fleet is ported
    ap.add_argument("--replicas", type=int, default=0)
    ap.add_argument("--mesh-axis", type=int, default=1)
    ap.add_argument("--disagg", action="store_true")
    ap.add_argument("--drain-timeout", type=float, default=30.0)
    args = ap.parse_args(argv)
    asked = [f for f, d in FLEET_DEFAULTS.items() if getattr(args, f) != d]
    if asked:
        raise NotImplementedError(
            f"the serving fleet ({', '.join('--' + f.replace('_', '-') for f in asked)}) "
            f"is not ported to repro_torch yet; the launcher runs the "
            f"classic static-batch path")
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


if __name__ == "__main__":
    main()
