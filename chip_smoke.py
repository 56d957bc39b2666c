"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

  1. device  — name, capability, ``nvidia-smi`` name and power limit;
  2. build   — compile every kernel of ``src/repro_torch/csrc`` (one nvcc
               per source, all started together); ptxas' registers and
               spills, and each library's count of tensor-core (HMMA /
               HGMMA) instructions in its SASS;
  3. kernels — K1 (awq_matmul) at Qwen2.5-0.5B's four (K, N) pairs ×
               M ∈ {1, 4, 16, 64}, GS 64; K3 (awq_gateup) at the gate/up
               pair 896→4864, GS 64, M ∈ {1, 4, 16, 64, 1024}, with and
               without AWQ input scales, in both output modes (f32, the
               TPU function; bf16, the model's rounding); K2 (paged_attention_chunk) at
               Hkv 2, G 7, hd 64, page 16, B 4, C ∈ {1, 16}, contexts up to
               512 with padding rows, and C = 8 with a token tree's
               ancestor mask, logical positions and a sliding window; each
               held against its plain version, and timed beside it and a
               library yardstick;
               K4 (flash_attention) at Qwen2.5's 14 q / 2 kv heads, hd 64,
               bf16: the calibration forward (B 2, S 64), the launcher's
               prefill (B 4, S 256), a ragged S 1000, a 128-token window
               and a bidirectional case;
  4. serve   — full-width Qwen2.5-0.5B (24 layers, random weights from a
               seed), RTN int4 GS 64, int8 KV pages, 8 greedy requests
               through `GenerationEngine.submit` / `step` / `drain`; the
               K1, K2 and K3 launch counters must grow during this run,
               and their launches per decode-only step and their
               launches in steps with prefill rows are reported;
  5. profile — decode steps of 4 slots, then chunk steps (4 rows of 16
               prompt tokens at contexts 64–448), timed bare and under
               torch.profiler: device busy time, idle share, top kernels;
  6. check   — one unified `chunk_step` on the card (K1 + K2) against the
               same step on CPU copies (plain versions);
  7. launch  — the launcher's AWQ path at full width,
               `repro_torch.launch.serve.main` with ``--arch qwen25-05b
               --quant awq --batch 4 --prompt-len 256 --max-new 32``:
               calibration forward (K4 in every layer), AWQ search + pack
               of all 168 linears, `generate()` (K4 prefill, K1 decode);
               K4 must launch in both the calibration forward and
               `generate()`, K1 in `generate()`;
  8. check_prefill — one `Model.prefill` (B 1, S 64) on the launcher's
               AWQ-packed weights on the card (K4 + K1 + K3) against the
               same prefill on CPU copies (plain versions);
  9. fleet   — the launcher's fleet path at full width,
               `repro_torch.launch.serve.main` with ``--arch qwen25-05b
               --quant awq --replicas 2 --mesh-axis 1 --batch 4
               --prompt-len 256 --max-new 32``: AWQ calibrate + pack, two
               paged replicas behind the prefix-affinity Router, pinned
               cluster prefixes, 8 greedy requests; it must skip prefill
               tokens, place by affinity and launch K1 and K3.

Each phase prints one JSON line. The end-to-end numbers are repeated on
a short ``summary`` line, followed by the ``kernels`` line (what each
kernel's numbers cover, its tolerances and the per-shape results are on
the ``kernel_shapes`` line before them) and, last,
``{"ok": true, "device": {...}}``; any failure raises and exits non-zero
before it. Without CUDA the script exits 1 at once. ``--out PATH`` also
writes every phase line to PATH as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import qlinear  # noqa: E402
from repro_torch.core.packing import (PackedLinear, dequantize_int4,  # noqa: E402
                                      pack_linear)
from repro_torch.core.pipeline import quantize_params  # noqa: E402
from repro_torch.core.quantize import QuantConfig, quantize_groupwise  # noqa: E402
from repro_torch.kernels import awq_matmul as k1  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import paged_attention as k2  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_OPS_PER_S = 989e12        # dense bf16 tensor cores
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
COLD_BYTES = 64 << 20          # rotate copies past the 50 MB L2
GS = 64
QWEN_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
# one decode layer's K1 calls at M = num_slots = 4: q, o, down (k and v,
# 2·4·896·128 < 2^20 flops, stay on the generic path; gate and up are K3)
LAYER_K1 = [(896, 896), (896, 896), (4864, 896)]


PHASES: dict[str, dict] = {}
# each kernel wrapper's launch count (one per launch of its kernel)
COUNTERS = {"awq_matmul": k1.COUNTER, "paged_attention_chunk": k2.COUNTER,
            "awq_gateup": k1.GATEUP_COUNTER, "flash_attention": k4.COUNTER}


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def read_counts(names=COUNTERS) -> dict:
    return {n: COUNTERS[n].count for n in names}


def phase(phase_name: str, **fields) -> None:
    PHASES[phase_name] = fields
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def time_ms(fn, n_inputs: int, iters: int = 40) -> float:
    """Mean device ms per call of ``fn(i)``, cycling inputs i (cold L2).

    A launch from Python costs the host tens of µs, more than a small
    kernel runs, so timing launches as they are issued would measure the
    host. The stream is first held by a spin kernel long enough for the
    host to enqueue every call; the events then see the calls run back
    to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / 3     # host + device, upper bound
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # cycles at the H100's top SM clock (1.98 GHz): a lower clock only
    # lengthens the hold
    torch.cuda._sleep(int(1.5 * iters * per_call_s * 2.0e9) + 1000)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_mma_count(lib: pathlib.Path) -> dict | None:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in a built
    library's SASS, by ``cuobjdump --dump-sass``; None without it."""
    tool = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return {op: sass.count(f" {op}.") for op in ("HMMA", "HGMMA")}


def bound(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least time for moving ``nbytes`` and doing each ``(ops, peak
    rate)`` part of the work on the units its types allow, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / peak for ops, peak in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ phase 3
def check_k1(gen) -> tuple[dict, dict]:
    cfg = QuantConfig(group_size=GS)
    shapes = []
    for k, n in QWEN_KN:
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        p = pack_linear(*quantize_groupwise(w, cfg), None, None, cfg)
        wbytes = p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
        copies = max(1, COLD_BYTES // wbytes)
        packs = [(p.qweight.clone(), p.scales.clone(), p.zeros.clone())
                 for _ in range(copies)]
        w_bf16 = dequantize_int4(p.qweight, p.scales, p.zeros, GS,
                                 torch.bfloat16)
        lib_w = [w_bf16.clone()
                 for _ in range(max(1, COLD_BYTES // w_bf16.nbytes))]
        for m in (1, 4, 16, 64):
            x = torch.randn(m, k, generator=gen,
                            device="cuda").to(torch.bfloat16)
            out = k1.awq_matmul(x, p.qweight, p.scales, p.zeros, GS)
            ref = k1.awq_matmul_ref(x, p.qweight, p.scales, p.zeros, GS,
                                    torch.bfloat16)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            if not err <= tol:
                raise AssertionError(f"K1 {k}x{n} M={m}: err {err} > {tol}")
            ms = time_ms(lambda i: k1.awq_matmul(x, *packs[i], GS), copies)
            plain = time_ms(lambda i: k1.awq_matmul_ref(
                x, *packs[i], GS, torch.bfloat16), copies)
            lib = time_ms(lambda i: torch.matmul(x, lib_w[i]), len(lib_w))
            nbytes = x.nbytes + wbytes + m * n * 4
            b_ms, b_by = bound(nbytes, (2 * m * k * n, BF16_OPS_PER_S))
            shapes.append(dict(k=k, n=n, m=m, max_abs_err=err, tol=tol,
                               ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by))
    layer = [next(s for s in shapes if (s["k"], s["n"], s["m"]) == (k, n, 4))
             for k, n in LAYER_K1]
    entry = dict(
        name="awq_matmul", route="cuda",
        source="src/repro_torch/csrc/awq_matmul.cu",
        replaces="src/repro/kernels/awq_matmul.py:99",
        max_abs_err=max(s["max_abs_err"] for s in shapes),
        ms=sum(s["ms"] for s in layer),
        plain_ms=sum(s["plain_ms"] for s in layer),
        bound_ms=sum(s["bound_ms"] for s in layer), bound_by="bytes",
        library_ms=sum(s["library_ms"] for s in layer))
    detail = dict(
        at="one decode layer at M=4: q, o, down (sums; gate and up run "
           "in K3)",
        tolerance="per shape: 1e-4 x max|plain| (shapes[].tol)",
        library_call="torch.matmul on the pre-dequantized bf16 weight "
                     "(not the same function: it skips the int4 unpack)",
        shapes=shapes)
    return entry, detail


def k3_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element tolerance of K3 against its plain version: the f32
    output (the TPU function) differs only by the order of sums (1e-4 of
    the output scale, as K1); the bf16 output rounds g, u, silu(g) and the
    product as the two-linear MLP does, and a sum a few f32 ulps off may
    round to a neighbouring value at each step (1e-5 of the output scale
    plus 2^-6 of the value: four bf16 ulps)."""
    scale = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        return torch.full_like(ref, 1e-4 * scale)
    return 1e-5 * scale + 2 ** -6 * ref.float().abs()


def check_k3(gen) -> tuple[dict, dict]:
    """K3 at the gate/up pair of every Qwen2.5 layer (896 → 4864, GS 64):
    each M with and without AWQ input scales, held against the plain
    version in both output modes; timed in the mode its caller uses
    (scaled: the model's bf16 output; unscaled: the TPU function's f32)."""
    cfg = QuantConfig(group_size=GS)
    k, n = 896, 4864
    g, u = (pack_linear(*quantize_groupwise(
        torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k), cfg),
        None, None, cfg) for _ in range(2))
    wbytes = sum(t.nbytes for p in (g, u)
                 for t in (p.qweight, p.scales, p.zeros))
    copies = max(1, COLD_BYTES // wbytes)
    packs = [tuple(t.clone() for p in (g, u)
                   for t in (p.qweight, p.scales, p.zeros))
             for _ in range(copies)]
    wg, wu = (dequantize_int4(p.qweight, p.scales, p.zeros, GS,
                              torch.bfloat16) for p in (g, u))
    lib_w = [(wg.clone(), wu.clone())
             for _ in range(max(1, COLD_BYTES // (2 * wg.nbytes)))]
    iscales = (torch.rand(k, generator=gen, device="cuda") + 0.5,
               torch.rand(k, generator=gen, device="cuda") + 0.5)
    shapes = []
    for m in (1, 4, 16, 64, 1024):
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        for scaled in (False, True):
            sc = iscales if scaled else None
            errs = {}
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(input_scales=sc, out_dtype=out_dtype)
                out = k1.awq_gateup(x, *packs[0], GS, **kw)
                ref = k1.awq_gateup_ref(x, *packs[0], GS, torch.bfloat16, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                lim = k3_tolerance(ref)
                if not bool((err <= lim).all()):
                    raise AssertionError(
                        f"K3 M={m} scaled={scaled} {out_dtype}: err exceeds "
                        f"its tolerance by {float((err - lim).max())}")
                errs[str(out_dtype).split(".")[-1]] = [
                    float(err.max()), float(lim.min())]
            kw = dict(input_scales=sc, out_dtype=(torch.bfloat16 if scaled
                                                  else torch.float32))
            ms = time_ms(lambda i: k1.awq_gateup(x, *packs[i], GS, **kw),
                         copies)
            plain = time_ms(lambda i: k1.awq_gateup_ref(
                x, *packs[i], GS, torch.bfloat16, **kw), copies, iters=10)
            lib = time_ms(lambda i: torch.nn.functional.silu(
                x @ lib_w[i][0]) * (x @ lib_w[i][1]), len(lib_w))
            out_bytes = m * n * (2 if scaled else 4)
            nbytes = (x.nbytes + wbytes + out_bytes
                      + (2 * k * 4 if scaled else 0))
            b_ms, b_by = bound(nbytes, (2 * 2 * m * k * n, BF16_OPS_PER_S))
            shapes.append(dict(m=m, input_scales=scaled, max_abs_err=errs,
                               ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by))
    dec = next(s for s in shapes if s["m"] == 4 and s["input_scales"])
    entry = dict(
        name="awq_gateup", route="cuda",
        source="src/repro_torch/csrc/awq_gateup.cu",
        replaces="src/repro/kernels/awq_matmul.py:171",
        max_abs_err=max(e[0] for s in shapes
                        for e in s["max_abs_err"].values()),
        ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"], library_ms=dec["library_ms"])
    detail = dict(
        at="one decode layer's gate/up pair at M=4 with AWQ input scales, "
           "bf16 output (the model path)",
        tolerance="f32 output: 1e-4 x max|plain|; bf16 output: 1e-5 x "
                  "max|plain| + 2^-6 x |plain| per element "
                  "(shapes[].max_abs_err: [max error, least tolerance])",
        library_call="silu(x @ Wg) * (x @ Wu) with torch.matmul on the "
                     "pre-dequantized bf16 weights (not the same function: "
                     "it skips the int4 unpack and the input scales)",
        shapes=shapes)
    return entry, detail


# K2's tree case: in-row parent of each node of an 8-node token tree (node
# 0 is the root, the slot's last sampled token), as tree speculation lays
# a verify row out
TREE_PARENTS = [-1, 0, 1, 2, 0, 4, 1, 6]


def _tree_mask(pos: torch.Tensor, window: int):
    """rpos (logical positions: base + depth) and amask (ancestor closure)
    for every row of ``pos`` holding TREE_PARENTS; row 0's node 5 is given
    an empty ancestor row and no committed keys, so it must come out 0."""
    c = len(TREE_PARENTS)
    anc = torch.zeros(c, c, dtype=torch.bool)
    depth = [0] * c
    for j, par in enumerate(TREE_PARENTS):
        if par >= 0:
            anc[j] = anc[par]
            depth[j] = depth[par] + 1
        anc[j, j] = True
    b = pos.shape[0]
    amask = (anc[None].expand(b, c, c).to(pos.device)
             & (pos >= 0)[:, None, :]).contiguous()
    amask[0, 5] = False
    rpos = torch.where(pos >= 0, pos[:, :1] + torch.tensor(
        depth, dtype=torch.int32, device=pos.device)[None], pos)
    return dict(rpos=rpos.to(torch.int32).contiguous(), amask=amask,
                window=window)


def _k2_inputs(gen, c: int, tree: bool = False):
    """q, pool copies (int8 codes + f32 strips, enough to pass the L2),
    page table, positions and visibility options (rpos / amask / window)
    for B 4 slots of 32 pages of 16 tokens."""
    b, hkv, g, hd, page, nblk = 4, 2, 7, 64, 16, 32
    npages = b * nblk + 1
    copies = max(1, COLD_BYTES // (2 * npages * page * hkv * (hd + 4)))
    pools = []
    for _ in range(copies):
        kp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=gen,
                           device="cuda", dtype=torch.int8)
        vp = torch.randint(-127, 128, (npages, page, hkv, hd), generator=gen,
                           device="cuda", dtype=torch.int8)
        ks = torch.rand(npages, page, hkv, generator=gen, device="cuda") / 50
        vs = torch.rand(npages, page, hkv, generator=gen, device="cuda") / 50
        pools.append((kp, ks, vp, vs))
    table = (torch.randperm(npages - 1, generator=gen, device="cuda")
             + 1).to(torch.int32).reshape(b, nblk)
    if c == 1:
        pos = torch.tensor([[-1], [137], [300], [511]], dtype=torch.int32,
                           device="cuda")                 # row 0: padding
    elif tree:
        base = torch.tensor([0, 137, 300, 0], dtype=torch.int32,
                            device="cuda")
        pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                           device="cuda")[None]
        pos[3] = -1                                       # padding row
    else:
        base = torch.tensor([0, 137, 300, 512 - c], dtype=torch.int32,
                            device="cuda")
        pos = base[:, None] + torch.arange(c, dtype=torch.int32,
                                           device="cuda")[None]
        pos[2, c // 2:] = -1                              # padded tail
    q = torch.randn(b, c, hkv, g, hd, generator=gen, device="cuda")
    kw = _tree_mask(pos, window=128) if tree else {}
    return q, pools, table, pos, kw


def check_k2(gen) -> tuple[dict, dict]:
    per_c = []
    for case, c in (("decode", 1), ("chunk", 16), ("tree", 8)):
        q, pools, table, pos, kw = _k2_inputs(gen, c, tree=case == "tree")
        b, _, hkv, g, hd = q.shape
        copies = len(pools)

        def run(i, fn):
            kp, ks, vp, vs = pools[i]
            return fn(q, kp, ks, vp, vs, table, pos, **kw)

        out = run(0, k2.paged_attention_chunk)
        ref = run(0, k2.paged_attention_chunk_ref)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        if not err <= tol:
            raise AssertionError(f"K2 {case} C={c}: err {err} > {tol}")
        s_slot = table.shape[1] * 16
        vis = k2.chunk_visibility_ref(pos, s_slot=s_slot, **kw)
        empty = ~vis.any(dim=-1)                     # padding + empty rows
        if case == "tree" and not bool(empty[0, 5]):
            raise AssertionError("K2 tree: row 0 node 5 should see nothing")
        if out[empty].abs().max() != 0:
            raise AssertionError(f"K2 {case}: rows that see nothing must "
                                 f"give exact 0")
        ms = time_ms(lambda i: run(i, k2.paged_attention_chunk), copies)
        plain = time_ms(lambda i: run(i, k2.paged_attention_chunk_ref),
                        copies, iters=10)
        # yardstick: SDPA over K/V already gathered and dequantized (bf16),
        # with the visibility as a boolean mask — not the same function
        mask = vis[:, None].expand(b, hkv * g, c, s_slot)
        kv = []
        for kp, ks, vp, vs in pools:
            kk = (kp.float() * ks[..., None])[table.long()].reshape(
                b, s_slot, hkv, hd).transpose(1, 2).to(torch.bfloat16)
            vv = (vp.float() * vs[..., None])[table.long()].reshape(
                b, s_slot, hkv, hd).transpose(1, 2).to(torch.bfloat16)
            kv.append((kk.contiguous(), vv.contiguous()))
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, c, hd).to(
            torch.bfloat16)
        lib = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qs, *kv[i], attn_mask=mask, enable_gqa=True), copies)
        # bytes this data needs: q, out, and for every row the int8 codes
        # + f32 scales of the keys its queries can see, per kv head
        keys = int(vis.any(dim=1).sum())             # (row, key) pairs
        visible = int(vis.sum())                     # (query, key) pairs
        nbytes = (2 * q.nbytes + keys * hkv * (2 * hd + 8)
                  + table.nbytes + pos.nbytes
                  + sum(t.nbytes for t in kw.values()
                        if isinstance(t, torch.Tensor)))
        b_ms, b_by = bound(nbytes,
                           (4 * visible * hkv * g * hd, F32_OPS_PER_S))
        per_c.append(dict(case=case, c=c, max_abs_err=err, tol=tol, ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by))
    dec = per_c[0]
    entry = dict(
        name="paged_attention_chunk", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:240",
        max_abs_err=max(s["max_abs_err"] for s in per_c),
        ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"], library_ms=dec["library_ms"])
    detail = dict(
        at="decode, C=1, B=4, contexts 137/300/511 + a padding row",
        design=f"keys split in spans of {k2.SPAN}, a block per span, kv "
               f"head and 8 query rows (4 warps of 32 keys; "
               f"{k2.smem_bytes(64)} B of shared memory at hd 64), then a "
               f"merge pass in span order: 2 kernel launches per call, "
               f"counted as 1",
        tolerance="per shape: 1e-5 x max(1, max|plain|) (shapes[].tol)",
        library_call="torch SDPA over gathered, dequantized bf16 K/V with "
                     "a boolean mask (not the same function)",
        shapes=per_c)
    return entry, detail


# K4 cases: name, B, S, causal, window (H 14, Hkv 2, hd 64, bf16)
K4_CASES = [("calibration", 2, 64, True, 0), ("prefill", 4, 256, True, 0),
            ("ragged", 1, 1000, True, 0), ("window", 1, 1000, True, 128),
            ("bidirectional", 4, 256, False, 0)]


def check_k4(gen) -> tuple[dict, dict]:
    """K4 at the shapes the launcher gives it. q, k and v are the
    [B, S, H, hd] projections passed as ``transpose(1, 2)`` views, as
    `attention()` passes them, and sit in L2 as the prefill leaves them."""
    h, hkv, hd, dt = 14, 2, 64, torch.bfloat16
    per_case = []
    for case, b, s, causal, window in K4_CASES:
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                   .to(dt).transpose(1, 2) for n in (h, hkv, hkv))
        kw = dict(causal=causal, window=window)
        out = k4.flash_attention(q, k, v, **kw)
        ref = k4.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        lim = 1e-5 + torch.finfo(dt).eps * ref.float().abs()
        if not bool((err <= lim).all()):
            raise AssertionError(f"K4 {case}: err exceeds 1e-5 + eps|ref| by "
                                 f"{float((err - lim).max())}")
        ms = time_ms(lambda i: k4.flash_attention(q, k, v, **kw), 1)
        plain = time_ms(lambda i: k4.flash_attention_ref(q, k, v, **kw), 1,
                        iters=10)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        mask = k4.visibility(s, causal=causal, window=window, device="cuda")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_kw = (dict(attn_mask=mask) if window
                  else dict(is_causal=causal))
        lib = time_ms(lambda i: sdpa(qc, kc, vc, enable_gqa=True, **lib_kw), 1)
        nbytes = q.nbytes + k.nbytes + v.nbytes + out.nbytes
        # per visible pair and head: QK^T's 2*hd flops on bf16 operands
        # (exact on tensor cores, f32 sums), and PV's 2*hd on f32
        # probabilities, which tensor cores take exactly as two bf16
        # halves (hi, lo) against the bf16 V: 2 x 2*hd
        pair_flops = 2 * hd * h * b * int(mask.sum())
        b_ms, b_by = bound(nbytes, (3 * pair_flops, BF16_OPS_PER_S))
        per_case.append(dict(case=case, b=b, s=s, causal=causal,
                             window=window, max_abs_err=float(err.max()),
                             ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=b_ms, bound_by=b_by))
    pre = next(c for c in per_case if c["case"] == "prefill")
    entry = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:108",
        max_abs_err=max(c["max_abs_err"] for c in per_case),
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=pre["library_ms"])
    detail = dict(
        at="the launcher's prefill: B 4, S 256, H 14 / Hkv 2, hd 64, bf16, "
           "causal",
        tolerance="per element: 1e-5 + bf16 eps (2^-7) x |plain|",
        bound="the larger of: bytes of Q, K, V, O at 3.35 TB/s; per "
              "visible (query, key) pair and head, QK^T's 2*hd flops plus "
              "PV's 2 x 2*hd (the f32 probabilities as two bf16 halves, "
              "exact against bf16 V) at 989 TFLOP/s; the kernel runs all "
              "three products on tensor cores (mma.sync)",
        library_call="torch SDPA (is_causal / boolean mask, enable_gqa) on "
                     "the same bf16 tensors, made contiguous",
        shapes=per_case)
    return entry, detail


# ------------------------------------------------------------------ phase 4
def serve(model, params) -> dict:
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, prefill_chunk=16, kv_quant="int8")
    rng = np.random.default_rng(SEED)
    lens = [16, 200, 45, 120, 77, 190, 33, 150]
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the serve path's kernels (K4 is not on it)
    names = ("awq_matmul", "awq_gateup", "paged_attention_chunk")
    # the main path: counts start at 0 here and are read right after
    reset_counts()
    qlinear.COUNTS.kernel = qlinear.COUNTS.generic = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, 32) for p in prompts]
    decode_s, decode_tokens, decode_steps, steps, prefilled = 0.0, 0, 0, 0, 0
    decode_launches = dict.fromkeys(names, 0)
    prefill_launches = dict.fromkeys(names, 0)
    while not eng.idle:
        before = read_counts(names)
        ts = time.perf_counter()
        events = eng.step()                 # ends in a device→host copy
        dt = time.perf_counter() - ts
        steps += 1
        now = eng.stats().prefill_tokens
        into = prefill_launches
        if now == prefilled:                # a step with decode rows only
            decode_s += dt
            decode_tokens += len(events)
            decode_steps += 1
            into = decode_launches
        for n, v in read_counts(names).items():
            into[n] += v - before[n]
        prefilled = now
    out = eng.drain()
    total_s = time.perf_counter() - t0
    launches = read_counts(names)
    paths = {"kernel": qlinear.COUNTS.kernel,
             "generic": qlinear.COUNTS.generic}
    for rid in rids:
        toks = out[rid]
        if toks.shape != (32,) or not ((toks >= 0)
                                       & (toks < model.cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: bad stream {toks}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    st = eng.stats()
    return dict(requests=len(rids), generated=32 * len(rids), steps=steps,
                dispatches=st.dispatches, serve_s=total_s,
                decode_tokens_per_s=decode_tokens / decode_s,
                decode_steps=decode_steps,
                decode_step_ms=1e3 * decode_s / max(1, decode_steps),
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                kv_pool_bytes=st.kv_pool_bytes, weight_bytes=st.weight_bytes,
                launches=launches,
                launches_per_decode_step={n: v / max(1, decode_steps)
                                          for n, v in decode_launches.items()},
                prefill_steps=steps - decode_steps,
                launches_in_decode_steps=decode_launches,
                launches_in_prefill_steps=prefill_launches,
                qlinear_calls=paths)


def _profile_steps(eng, steps: int, before=lambda: None) -> dict:
    """``steps`` engine steps timed bare, then as many again under
    torch.profiler for the device's busy time and its top kernels;
    ``before()`` sets up each window."""
    before()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    bare_ms = 1e3 * (time.perf_counter() - t0) / steps
    before()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / steps
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    return dict(steps=steps, step_ms=bare_ms,
                profiled_step_ms=prof_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / prof_ms,
                top_kernels=[dict(name=e.key[:90], count=e.count / steps,
                                  ms=e.self_device_time_total / 1e3 / steps)
                             for e in top[:10]])


def profile(model, params, steps: int = 6) -> dict:
    """Where a step's time goes. Decode: 4 slots decoding at contexts
    ~100–112 (no prefill). Chunk: a step of 4 rows of 16 prompt tokens
    (the scheduler packs one long prompt's chunks into every free row),
    at contexts 64–448 of a 448-token prompt, a fresh prompt for the bare
    and the profiled window; every K2 launch there reads a C = 16 chunk."""
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, prefill_chunk=16, kv_quant="int8")
    rng = np.random.default_rng(SEED + 2)
    for _ in range(4):
        eng.submit(rng.integers(0, model.cfg.vocab_size, 100)
                   .astype(np.int32), 64)
    while eng.stats().prefill_tokens < 400:     # land every prompt
        eng.step()
    eng.step()
    dec = dict(slots=4, context=100, **_profile_steps(eng, steps))
    eng = GenerationEngine(model, params, num_slots=4, page_size=16,
                           max_seq=512, prefill_chunk=16, kv_quant="int8")
    plen = 64 * (steps + 1)

    def new_prompt():                 # its first 64 tokens land unprofiled
        if not eng.idle:
            raise AssertionError("profile: the last prompt did not finish")
        eng.submit(rng.integers(0, model.cfg.vocab_size, plen)
                   .astype(np.int32), 1)
        eng.step()

    chunk = dict(rows=4, chunk=16, contexts=[64, plen],
                 **_profile_steps(eng, steps, before=new_prompt))
    if eng.stats().prefill_tokens != 2 * plen or not eng.idle:
        raise AssertionError("profile: the chunk steps did not each land "
                             "4 rows of 16 prompt tokens")
    return dict(dec, chunk_step=chunk)


# ------------------------------------------------------------------ phase 5
def tree_to(tree, device):
    if isinstance(tree, PackedLinear):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def cross_check(model, params) -> dict:
    """One prefill chunk (C=16) and one decode step (C=1) of the unified
    chunk step on the card vs CPU copies (plain versions). bf16
    activations round differently once K2 dequantizes K/V in f32 (card)
    instead of to bf16 (CPU gather path), so logits are held at 5% of
    their largest magnitude, and the argmax must agree on rows whose
    top-2 margin clears that tolerance."""
    cpu_params = tree_to(params, "cpu")
    rng = np.random.default_rng(SEED + 1)
    table = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    toks_a = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (4, 16))
                              .astype(np.int32))
    pos_a = torch.arange(16, dtype=torch.int32)[None].repeat(4, 1)
    pos_a[3, 10:] = -1
    sidx_a = torch.tensor([15, 15, 15, 9], dtype=torch.int32)
    toks_b = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (4, 1))
                              .astype(np.int32))
    pos_b = torch.tensor([[16], [16], [16], [10]], dtype=torch.int32)
    sidx_b = torch.zeros(4, dtype=torch.int32)
    pools = {d: model.init_paged_cache(17, 16, kv_quant="int8", device=d)
             for d in ("cuda", "cpu")}
    prm = {"cuda": params, "cpu": cpu_params}
    res = {}
    for step, (toks, pos, sidx) in enumerate(((toks_a, pos_a, sidx_a),
                                              (toks_b, pos_b, sidx_b))):
        if step == 1:      # both sides read the card's committed pages
            pools["cpu"] = tree_to(pools["cuda"], "cpu")
        logits = {}
        for d in ("cuda", "cpu"):
            with torch.no_grad():
                lg, pools[d] = model.chunk_step(
                    prm[d], pools[d], toks.to(d), pos.to(d), sidx.to(d),
                    page_table=table.to(d))
            logits[d] = lg.float().cpu()
        ref, got = logits["cpu"], logits["cuda"]
        err = float((got - ref).abs().max())
        tol = 0.05 * float(ref.abs().max())
        top2 = torch.topk(ref, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = (got.argmax(-1) == ref.argmax(-1))
        if not err <= tol or not bool(agree[clear].all()):
            raise AssertionError(f"cross-check step {step}: err {err} > "
                                 f"{tol} or argmax differs on clear rows")
        res[f"step{step}"] = dict(max_abs_err=err, tol=tol,
                                  clear_rows=int(clear.sum()),
                                  argmax_agree=int(agree.sum()))
    return res


# ------------------------------------------------------------------ phase 7
LAUNCH_ARGS = ["--arch", "qwen25-05b", "--quant", "awq", "--batch", "4",
               "--prompt-len", "256", "--max-new", "32"]


def launch() -> tuple[dict, dict]:
    """The launcher's AWQ path at full width; returns (phase fields, the
    served AWQ params)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launcher's path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    out = launcher.main(LAUNCH_ARGS)
    total_s = time.perf_counter() - t0
    totals = read_counts()
    rep, by_step = out["report"], out["launches"]
    toks = out["tokens"]
    if out["shape"] != [4, 32] or not ((toks >= 0) & (toks < 151936)).all():
        raise AssertionError(f"launch: bad tokens {out['shape']}")
    if not len(rep.calibrated) == len(rep.quantized) == 168:
        raise AssertionError(f"launch: {len(rep.calibrated)} of "
                             f"{len(rep.quantized)} linears calibrated, "
                             f"want all 168")
    if not (by_step["calibrate"]["flash_attention"] >= 24
            and by_step["generate"]["flash_attention"] >= 24
            and by_step["generate"]["awq_matmul"] > 0
            and by_step["generate"]["awq_gateup"] > 0):
        raise AssertionError(f"launch: a kernel of the path never ran: "
                             f"{by_step}")
    fields = dict(
        args=" ".join(LAUNCH_ARGS), total_s=total_s,
        calibrate_s=out["calib_s"], awq_s=out["awq_s"],
        quantized=len(rep.quantized), calibrated=len(rep.calibrated),
        skipped=len(rep.skipped), compression_ratio=rep.compression_ratio,
        fp16_bytes=out["fp16_bytes"], awq_macro_bytes=out["macro_bytes"],
        generate_s=out["generate_s"], tokens_per_s=out["tokens_per_s"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=totals, launches_by_step=by_step,
        sample=toks[0][:8].tolist())
    return fields, out["params"]


# ------------------------------------------------------------------ phase 8
def check_prefill(model, params) -> dict:
    """One full-sequence prefill (B 1, S 64) on the launcher's AWQ-packed
    weights, on the card (K4 attention, K1 projections) and on CPU copies
    (plain versions). The bf16 activations round differently once the
    sums run in another order, and the differences grow over 24 layers,
    so the last position's logits are held at 5% of their largest
    magnitude, as `cross_check` holds a chunk step, and the argmax must
    agree if the top-2 margin clears that tolerance."""
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, 64))
                            .astype(np.int32))
    prm = {"cuda": params, "cpu": tree_to(params, "cpu")}
    before = k4.COUNTER.count
    logits = {}
    for d in ("cuda", "cpu"):
        with torch.no_grad():
            cache = model.init_cache(1, 64, device=d)
            _, lg, _ = model.prefill(prm[d], {"tokens": toks.to(d)}, cache)
        logits[d] = lg.float().cpu()
    ref, got = logits["cpu"], logits["cuda"]
    err = float((got - ref).abs().max())
    tol = 0.05 * float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values[0]
    clear = bool(top2[0] - top2[1] > 2 * tol)
    agree = bool(got.argmax() == ref.argmax())
    if not err <= tol or (clear and not agree):
        raise AssertionError(f"check_prefill: err {err} > {tol} or argmax "
                             f"differs on a clear row")
    if k4.COUNTER.count - before != model.cfg.num_layers:
        raise AssertionError("check_prefill: the card's prefill did not run "
                             "K4 once per layer")
    return dict(max_abs_err=err, tol=tol, argmax_agree=agree,
                margin_clear=clear)


# ------------------------------------------------------------------ phase 9
FLEET_ARGS = ["--arch", "qwen25-05b", "--quant", "awq", "--replicas", "2",
              "--mesh-axis", "1", "--batch", "4", "--prompt-len", "256",
              "--max-new", "32"]


def fleet() -> dict:
    """The launcher's fleet path at full width: AWQ calibrate + pack, two
    paged replicas (bf16 pools) sharing the params behind the Router."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the fleet path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    out = launcher.main(FLEET_ARGS)
    total_s = time.perf_counter() - t0
    totals = read_counts()
    streams = out["streams"]
    if out["requests"] != 8 or len(streams) != 8:
        raise AssertionError(f"fleet: {out['requests']} requests, want 8")
    for toks in streams:
        if toks.shape != (32,) or not ((toks >= 0) & (toks < 151936)).all():
            raise AssertionError(f"fleet: bad stream {toks}")
    if not (out["prefill_tokens_skipped"] > 0 and out["affinity_hits"] > 0):
        raise AssertionError(f"fleet: no prefix reuse: "
                             f"{out['prefill_tokens_skipped']} tokens "
                             f"skipped, {out['affinity_hits']} affinity hits")
    fleet_launches = out["launches"]["fleet"]
    if not (fleet_launches["awq_matmul"] > 0
            and fleet_launches["awq_gateup"] > 0):
        raise AssertionError(f"fleet: a kernel of the path never ran: "
                             f"{fleet_launches}")
    return dict(
        args=" ".join(FLEET_ARGS), total_s=total_s, fleet_s=out["fleet_s"],
        tokens_per_s=out["tokens_per_s"], requests=out["requests"],
        generated=int(sum(len(t) for t in streams)),
        prefill_tokens_skipped=out["prefill_tokens_skipped"],
        placements=out["placements"], affinity_hits=out["affinity_hits"],
        session_hits=out["session_hits"],
        calibrated=len(out["report"].calibrated),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=totals, launches_by_step=out["launches"],
        sample=streams[0][:8].tolist())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every phase line to this "
                                  "JSON file")
    ap.add_argument("--profile-only", action="store_true",
                    help="build, then only the profile phase (decode and "
                         "chunk steps); prints no kernels or ok line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    phase("device", name=name, capability=list(
        torch.cuda.get_device_capability(0)), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(smi, flush=True)

    t = time.perf_counter()
    built = build.build_all()
    phase("build", seconds=time.perf_counter() - t,
          per_source={n: b.seconds for n, b in built.items()},
          ptxas=[ln.strip() for b in built.values() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln],
          sass_tensor_core_instructions={
              n: sass_mma_count(b.path) for n, b in built.items()})

    if args.profile_only:
        model = Model(get_config("qwen25-05b"))
        params, _ = quantize_params(model.init(
            torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
        phase("profile", **profile(model, params))
        return

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    (k1_entry, k1_detail), (k2_entry, k2_detail) = check_k1(gen), check_k2(gen)
    k3_entry, k3_detail = check_k3(gen)
    k4_entry, k4_detail = check_k4(gen)
    kernels = [k1_entry, k2_entry, k3_entry, k4_entry]
    phase("kernel_shapes", awq_matmul=k1_detail,
          paged_attention_chunk=k2_detail, awq_gateup=k3_detail,
          flash_attention=k4_detail)

    cfg = get_config("qwen25-05b")
    model = Model(cfg)
    t = time.perf_counter()
    params, report = quantize_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda"))
    torch.cuda.synchronize()
    phase("model", config=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, quantized_linears=len(report.quantized),
          group_size=GS, init_quantize_s=time.perf_counter() - t)
    served = serve(model, params)
    phase("serve", **served)
    prof = profile(model, params)
    phase("profile", **prof)
    checked = cross_check(model, params)
    phase("check", **checked)
    del params
    torch.cuda.empty_cache()

    launched, awq_params = launch()
    phase("launch", **launched)
    # each kernel's launches on the path that carries it: K1, K2 and K3
    # while the engine serves, K4 in the launcher's calibration and
    # generate()
    k1_entry["launches"] = served["launches"]["awq_matmul"]
    k2_entry["launches"] = served["launches"]["paged_attention_chunk"]
    k3_entry["launches"] = served["launches"]["awq_gateup"]
    k4_entry["launches"] = launched["launches"]["flash_attention"]
    prefilled = check_prefill(model, awq_params)
    phase("check_prefill", **prefilled)
    del awq_params
    torch.cuda.empty_cache()
    served_fleet = fleet()
    phase("fleet", **served_fleet)

    phase("summary", gpu=smi, **{k: served[k] for k in (
        "decode_tokens_per_s", "decode_step_ms", "decode_steps", "steps",
        "serve_s", "peak_mem_bytes", "launches", "launches_per_decode_step",
        "qlinear_calls")},
        profile={k: prof[k] for k in ("step_ms", "profiled_step_ms",
                                      "device_busy_ms", "device_idle_share")},
        profile_chunk_step={k: prof["chunk_step"][k] for k in (
            "step_ms", "profiled_step_ms", "device_busy_ms",
            "device_idle_share")},
        check={s: [v["max_abs_err"], v["tol"]] for s, v in checked.items()},
        launch={k: launched[k] for k in (
            "calibrate_s", "awq_s", "calibrated", "compression_ratio",
            "awq_macro_bytes", "tokens_per_s", "peak_mem_bytes",
            "launches_by_step")},
        check_prefill=[prefilled["max_abs_err"], prefilled["tol"]],
        fleet={k: served_fleet[k] for k in (
            "fleet_s", "tokens_per_s", "requests", "generated",
            "prefill_tokens_skipped", "placements", "affinity_hits",
            "peak_mem_bytes", "launches")})
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {**PHASES, "kernels": kernels}, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
