"""ROADMAP Queue 3's check, with and without its fix, on one NVIDIA GPU.

For glm4-9b, smollm-360m, qwen2-moe-a2.7b and hymba-1.5b at the widths
and depths `chip_smoke.py` serves them (RTN int4 weights from seed 0),
the serve prompts go through the one-shot engine over bf16 pools with
every quantized linear on K1 / K3, and each stream is held against
`generate()` at B 1 under the same config, twice: with the port's cache
reads (`models.attention._sdpa`: products and softmax in f64 on the
card) and with the f32 arithmetic they replaced (the CPU's branch of
`_sdpa`, run on the card). Prints one JSON line: identical streams of 8
and each stream's first differing position, by model and read.

Run from the root of a checkout: ``python3 scripts/queue3_oneshot_bf16.py``
(about two minutes on an H100, the kernels' build included).
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import qlinear  # noqa: E402
from repro_torch.core.pipeline import quantize_params  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.numerics import einsum_f32  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402

ARCHS = ("glm4-9b", "smollm-360m", "qwen2-moe-a2.7b", "hymba-1.5b")


def sdpa_f32(q, k, v, q_pos, k_pos, *, causal, window, scale, vis=None,
             probs_dtype=torch.float32):
    """`_sdpa` with the f32 products (cuBLAS on the card) and the f32
    softmax it used before its reads went to f64 on the card."""
    scores = einsum_f32("bqkgd,bskd->bkgqs", q, k) * scale
    neg = torch.full_like(scores, -1e30)
    if vis is not None:
        vism = vis[:, None, None, :, :]
        probs = torch.softmax(torch.where(vism, scores, neg), dim=-1)
        probs = torch.where(vism.any(dim=-1, keepdim=True), probs,
                            torch.zeros_like(probs))
    else:
        mask = k_pos[:, None, :] >= 0
        if causal:
            mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
        if window:
            mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
        probs = torch.softmax(torch.where(mask[:, None, None, :, :], scores,
                                          neg), dim=-1)
    return einsum_f32("bkgqs,bskd->bqkgd", probs.to(probs_dtype),
                      v).to(v.dtype)


def streams(model, params, spec, prompts) -> dict:
    """Identical streams of the one-shot engine over bf16 pools against
    `generate()` at B 1, both under K1 / K3."""
    with qlinear.execution_config(cs.ALL_KERNEL):
        ref_eng = GenerationEngine(model, params, max_seq=spec["max_seq"])
        refs = [ref_eng.generate({"tokens": p[None]}, 32)[0] for p in prompts]
        eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                               max_seq=spec["max_seq"], kv_quant="none",
                               chunked_prefill=False)
        rids = [eng.submit(p, 32) for p in prompts]
        out = eng.drain()
    diffs = cs._first_diffs([out[r] for r in rids], refs)
    return dict(identical_streams=sum(d is None for d in diffs),
                first_diffs=diffs)


def main() -> None:
    if not torch.cuda.is_available():
        print("queue3_oneshot_bf16: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    reads = {"f64": attention._sdpa, "f32": sdpa_f32}
    res = {}
    for arch in ARCHS:
        spec = cs.DENSE_ARCHS[arch]
        with cs._depth(arch, spec["layers"]):
            cfg = cs.get_config(arch)
        model = Model(cfg)
        params, _ = quantize_params(model.init(
            torch.Generator(device="cuda").manual_seed(cs.SEED),
            device="cuda"))
        prompts = cs.dense_prompts(cfg.vocab_size, spec["serve_lens"])
        res[arch] = {"layers": cfg.num_layers}
        for name, fn in reads.items():
            attention._sdpa = fn
            try:
                res[arch][name] = streams(model, params, spec, prompts)
            finally:
                attention._sdpa = reads["f64"]
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"queue3_oneshot_bf16": res, "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
