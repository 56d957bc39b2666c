"""Plain reference of a dense GQA decoder, in float32 PyTorch.

The model as its configuration states it: int4 weights rounded to nearest
at group size 64 (this file's own copy of the rule, from the same float
weights the program got), keys and values stored as int8 per token and
head (absmax / 127), everything else in float32 with TF32 off. Each
sequence runs whole and causal, layer by layer, with no cache, no paging
and no batching; the layers are made again from the seed one at a time,
so only one layer's weights are resident.

``act="fp8"`` is the control: the inputs of every linear rounded to
float8 e4m3 (one scale a row, its absmax at 448), the precision below the
program's bfloat16.

Departure from the published models, kept from the program's own
convention: RoPE rotates the two halves of the rotated span of each head
(GLM-4 pairs neighbouring channels; under random weights the two differ
by a fixed permutation of q and k columns).
"""
from __future__ import annotations

import torch

from perfbench.models.dense_gqa import global_floats, layer_floats

FP8_MAX = 448.0


def rtn_int4(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """``w [K, N]`` rounded to asymmetric int4 per (group of K rows,
    column) and back to float32."""
    k, n = w.shape
    g = w.reshape(k // group_size, group_size, n)
    lo, hi = g.amin(dim=1), g.amax(dim=1)
    scale = (hi - lo) / 15
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zero = torch.clip(torch.round(-lo / scale), 0, 15)
    q = torch.clip(torch.round(g / scale[:, None]) + zero[:, None], 0, 15)
    return ((q - zero[:, None]) * scale[:, None]).reshape(k, n)


def int8_kv(x: torch.Tensor) -> torch.Tensor:
    """``x [..., hd]`` stored as int8 with one absmax scale per vector,
    read back as float32."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / torch.tensor(127.0, device=x.device))
    return torch.clip(torch.round(x / scale), -127, 127) * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a row."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, pos: torch.Tensor, rot: int,
         theta: float) -> torch.Tensor:
    """Rotate the first ``rot`` channels of ``x [L, H, hd]``: channel j
    of the first half with channel j of the second, by angle
    ``pos * theta^(-2j / rot)``."""
    half = rot // 2
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                  device=x.device) / rot)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:rot]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, x[..., rot:]],
                     dim=-1)


class Reference:
    """The reference over one configuration's ``port`` sizes."""

    def __init__(self, cfg: dict, quant: dict, seed: int, device,
                 act: str | None = None, q_block: int = 1024):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.gs = int(quant["group_size"])
        self.act = act
        self.q_block = q_block

    def _lin(self, x, w, b=None):
        if self.act == "fp8":
            x = fp8_rows(x)
        y = x @ w
        return y if b is None else y + b

    def _attend(self, q, k, v):
        """Causal attention of ``q [L, H, hd]`` over ``k, v [L, Hkv,
        hd]``; returns ``[L, H * hd]``."""
        n, h, hd = q.shape
        hkv = k.shape[1]
        qg = q.reshape(n, hkv, h // hkv, hd).permute(1, 2, 0, 3)
        kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)
        out = torch.empty_like(qg)
        keys = torch.arange(n, device=q.device)
        for lo in range(0, n, self.q_block):
            hi = min(n, lo + self.q_block)
            s = torch.einsum("hgqd,hkd->hgqk", qg[:, :, lo:hi],
                             kt[:, :hi]) * hd ** -0.5
            mask = keys[None, :hi] <= torch.arange(lo, hi,
                                                   device=q.device)[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            out[:, :, lo:hi] = torch.einsum("hgqk,hkd->hgqd",
                                            torch.softmax(s, dim=-1),
                                            vt[:, :hi])
        return out.permute(2, 0, 1, 3).reshape(n, h * hd)

    def _layer(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = x.shape[0]
        h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        rot = int(hd * cfg.get("rope_fraction", 1.0))
        rot -= rot % 2
        pos = torch.arange(n, device=x.device)
        a = rmsnorm(x, p["attn_norm"], cfg["norm_eps"])
        q = self._lin(a, p["wq"], p.get("bq")).reshape(n, h, hd)
        k = self._lin(a, p["wk"], p.get("bk")).reshape(n, hkv, hd)
        v = self._lin(a, p["wv"], p.get("bv")).reshape(n, hkv, hd)
        q = rope(q, pos, rot, cfg["rope_theta"])
        k = int8_kv(rope(k, pos, rot, cfg["rope_theta"]))
        v = int8_kv(v)
        x = x + self._lin(self._attend(q, k, v), p["wo"])
        m = rmsnorm(x, p["mlp_norm"], cfg["norm_eps"])
        hmid = torch.nn.functional.silu(self._lin(m, p["gate"])) \
            * self._lin(m, p["up"])
        return x + self._lin(hmid, p["down"])

    @torch.no_grad()
    def logits(self, seqs: list, starts: list) -> list:
        """Float32 logits ``[len(seq) - start, V]`` of each token sequence
        (int64 on the device) from position ``start`` on."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, dev = self.cfg, self.device
        g = global_floats(cfg, self.seed, dev)
        xs = [g["embed"][s] for s in seqs]
        for i in range(cfg["num_layers"]):
            p = layer_floats(cfg, self.seed, i, dev)
            for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
                p[name] = rtn_int4(p[name], self.gs)
            xs = [self._layer(p, x) for x in xs]
            del p
        head = g["embed"].t() if cfg["tie_embeddings"] else g["head"]
        return [rmsnorm(x[st:], g["final_norm"], cfg["norm_eps"]) @ head
                for x, st in zip(xs, starts)]
