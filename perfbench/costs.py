"""The yardstick's arithmetic: the card's peaks, a serving step's useful
FLOPs by the port's cost-model decode rule (``roofline/costmodel.py`` as
of this benchmark's first version, frozen here) for the dense attention
decoders the benchmark runs, and each kernel's operations and bytes from
the shapes of one call.

Everything here reads a configuration file's ``port`` sizes (a plain
dict), never the program, so a later change to the program's cost model
moves no benchmark number.
"""
from __future__ import annotations

# Published peaks (NVIDIA's data sheet, SXM part, dense rates, 700 W):
# bf16 tensor cores, float32 outside the tensor cores, HBM bandwidth.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}

F32 = 4


def peaks(device_kind: str) -> dict | None:
    """The peaks of the card named ``device_kind``, None for a card the
    table does not hold (its roofline metrics then read nothing)."""
    for key, val in PEAKS.items():
        if key in device_kind:
            return val
    return None


# ------------------------------------------------------------ model costs
def q_dim(cfg: dict) -> int:
    return cfg["num_heads"] * cfg["head_dim"]


def kv_dim(cfg: dict) -> int:
    return cfg["num_kv_heads"] * cfg["head_dim"]


def linear_dims(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of every linear of one attention + GLU / plain MLP block."""
    d = cfg["d_model"]
    dims = [(d, q_dim(cfg)), (d, kv_dim(cfg)), (d, kv_dim(cfg)),
            (q_dim(cfg), d)]
    if cfg.get("mlp_type", "glu") == "glu":
        dims += [(d, cfg["d_ff"]), (d, cfg["d_ff"]), (cfg["d_ff"], d)]
    else:
        dims += [(d, cfg["d_ff"]), (cfg["d_ff"], d)]
    return dims


def step_flops(cfg: dict, positions: int, key_sum: int,
               sampled: int) -> float:
    """Useful FLOPs of one serving step: ``positions`` prompt and decode
    tokens through every linear, attention of each over the keys it sees
    (``key_sum``: the sum over positions of visible keys) and the head
    at ``sampled`` rows (the cost model's decode rule, per position)."""
    lin = sum(2.0 * k * n for k, n in linear_dims(cfg))
    att = 2.0 * (2 * q_dim(cfg))
    return (cfg["num_layers"] * (positions * lin + key_sum * att)
            + sampled * 2.0 * cfg["vocab_size"] * cfg["d_model"])


# ----------------------------------------------------------- kernel costs
def awq_matmul_cost(m: int, k: int, n: int, gs: int, x_bytes: int,
                    out_bytes: int) -> tuple[float, float]:
    """K1: (flops, bytes) of ``[M, K] x int4 [K, N]``: x, the packed
    words, f32 scales, int8 zeros and the f32 input scale read once, the
    output written once."""
    w = k * n / 2 + (k // gs) * n * (F32 + 1) + k * F32
    return 2.0 * m * k * n, m * k * x_bytes + w + m * n * out_bytes


def awq_gateup_cost(m: int, k: int, n: int, gs: int, x_bytes: int,
                    out_bytes: int) -> tuple[float, float]:
    """K3: (flops, bytes) of ``silu(x Wg) * (x Wu)``: x once, both weights
    once, the product written once."""
    w = k * n / 2 + (k // gs) * n * (F32 + 1) + k * F32
    return 4.0 * m * k * n, m * k * x_bytes + 2 * w + m * n * out_bytes


def paged_attention_cost(heads: int, hkv: int, hd: int, c: int,
                         n_blocks: int, row_keys: list[int],
                         row_key_sum: int) -> tuple[float, float]:
    """K2: (flops, bytes) of one chunk call over int8 pages: every row's
    f32 queries read and outputs written, the int8 keys and values each
    row's positions make visible (``row_keys``: per row, the largest
    position + 1) with their f32 scales, the row's page table, positions
    and logical positions; QK and PV over ``row_key_sum`` (the sum over
    valid positions of the keys each sees)."""
    b = len(row_keys)
    q = b * c * heads * hd * F32
    kv = sum(row_keys) * hkv * 2 * (hd + F32)
    meta = b * n_blocks * 4 + 2 * b * c * 4
    return 4.0 * heads * hd * row_key_sum, 2 * q + kv + meta
