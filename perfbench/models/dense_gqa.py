"""Seeded float weights of a dense GQA decoder (attention with optional
QKV bias, partial RoPE, a GLU MLP, RMSNorm, tied or untied head), drawn on
the device in a few large calls, and the parameter tree the port's
`Model` takes for them.

Each layer, and the embedding and head, draws from its own
`torch.Generator` seeded from (``seed``, part), so the reference can make
any layer again without the others: the program and the reference get
the same float tensors from the same seed.
"""
from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def generator(seed: int, part: int, device) -> torch.Generator:
    """The generator of one part (0: embedding, head and final norm;
    1 + i: layer i) under ``seed``."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + part * 0xBF58476D1CE4E5B9
             + 0x94D049BB133111EB) & _MASK
    return torch.Generator(device=device).manual_seed(mixed)


def _split(flat: torch.Tensor, shapes: dict) -> dict:
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def layer_floats(cfg: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s float32 weights: linears ``[K, N]`` N(0, 1/K), q / k /
    v biases N(0, 0.1^2), norm gains 1 + N(0, 0.1^2)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    qd = cfg["num_heads"] * cfg["head_dim"]
    kvd = cfg["num_kv_heads"] * cfg["head_dim"]
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
              "gate": (d, f), "up": (d, f), "down": (f, d),
              "attn_norm": (d,), "mlp_norm": (d,)}
    if cfg["qkv_bias"]:
        shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, 1 + i, device),
                       device=device, dtype=torch.float32)
    p = _split(flat, shapes)
    for name, t in p.items():
        if t.dim() == 2:
            t.mul_(1.0 / math.sqrt(t.shape[0]))
        elif name.startswith("b"):
            t.mul_(0.1)
        else:
            t.mul_(0.1).add_(1.0)
    return p


def global_floats(cfg: dict, seed: int, device) -> dict:
    """Embedding ``[V, d]`` N(0, 0.02^2), final norm gain 1 + N(0, 0.1^2)
    and, untied, the head ``[d, V]`` N(0, 1/d)."""
    v, d = cfg["vocab_size"], cfg["d_model"]
    shapes = {"embed": (v, d), "final_norm": (d,)}
    if not cfg["tie_embeddings"]:
        shapes["head"] = (d, v)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, 0, device),
                       device=device, dtype=torch.float32)
    p = _split(flat, shapes)
    p["embed"].mul_(0.02)
    p["final_norm"].mul_(0.1).add_(1.0)
    if "head" in p:
        p["head"].mul_(1.0 / math.sqrt(d))
    return p


# --------------------------------------------------- the port's layout
def port_layer(p: dict) -> dict:
    """One layer's entry of the port's ``params["segments"]["seg_0"]``.
    Vectors are copied out of the layer's draw, so that the draw is freed
    once its linears are packed."""
    p = {k: v.clone() if v.dim() == 1 else v for k, v in p.items()}

    def lin(w, b=None):
        return {"w": w} if b is None else {"w": w, "b": b}
    return {
        "pre_norm": {"gamma": p["attn_norm"]},
        "attn": {"wq": lin(p["wq"], p.get("bq")),
                 "wk": lin(p["wk"], p.get("bk")),
                 "wv": lin(p["wv"], p.get("bv")),
                 "wo": lin(p["wo"])},
        "mlp_norm": {"gamma": p["mlp_norm"]},
        "mlp": {"gate": lin(p["gate"]), "up": lin(p["up"]),
                "down": lin(p["down"])},
    }


def port_tree(g: dict, layers: list) -> dict:
    """The port's whole parameter tree around already-built layers."""
    tree = {"embed": {"table": g["embed"]},
            "segments": {"seg_0": layers},
            "final_norm": {"gamma": g["final_norm"]}}
    if "head" in g:
        tree["lm_head"] = {"w": g["head"]}
    return tree
