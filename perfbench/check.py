"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished (drawn from the seed, the longest one
always in it, until it holds ``sample.tokens`` served tokens) runs through
the configuration's plain reference over its prompt and served tokens.
For each served token, the gap by which the reference's logit of that
token lies below the reference's best logit at that position (0 where the
program served the reference's best). Served tokens are greedy, so a
sound program serves each position's best token or one within rounding
of it. The numbers the cell's ``checks/<workload>.json`` gives a limit
are compared: the mean gap over the sample (``mean_logit_gap``); the
widest gap and the share of positions not at the reference's best are
printed beside it.

The control (`control_gaps`) puts the reference computed a precision
lower in the program's place: at each position of the same prompts and
tokens, the gap of the token the lower precision puts first.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch


def sample(finished: dict, prompts: dict, seed: int, tokens: int,
           max_requests: int) -> list[int]:
    """Request ids to check: the longest finished request (prompt plus
    output), then others in an order drawn from the seed, until the
    sample holds ``tokens`` served tokens or ``max_requests`` requests."""
    rids = sorted(finished)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(prompts[r]) + len(finished[r]), r))
    rest = [r for r in rids if r != longest]
    order = np.random.default_rng([int(seed), 0x636B]).permutation(len(rest))
    picked, served = [longest], len(finished[longest])
    for j in order:
        if served >= tokens or len(picked) >= max_requests:
            break
        picked.append(rest[j])
        served += len(finished[rest[j]])
    return picked


def reference_class(family: str):
    return importlib.import_module(f"perfbench.reference.{family}").Reference


def _sequences(rids, finished, prompts, device):
    seqs, starts, served = [], [], []
    for r in rids:
        p = np.asarray(prompts[r], np.int64)
        out = np.asarray(finished[r], np.int64)
        seqs.append(torch.as_tensor(np.concatenate([p, out[:-1]]),
                                    device=device))
        starts.append(len(p) - 1)
        served.append(torch.as_tensor(out, device=device))
    return seqs, starts, served


def gap_stats(ref_logits: list, tokens: list) -> dict:
    """Over every position: the widest gap of ``tokens``' logit below the
    best logit, the mean gap, and the share of positions whose token is
    not the best (all from the reference's logits)."""
    widest, total, flips, n = 0.0, 0.0, 0, 0
    for lg, tok in zip(ref_logits, tokens):
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        total += float(gap.sum())
        flips += int((gap > 0).sum())
        n += int(tok.numel())
    return {"widest": widest, "mean": total / max(n, 1),
            "flip_share": flips / max(n, 1), "tokens": n}


def served_gaps(config: dict, seed: int, rids, finished, prompts,
                device) -> dict:
    """`gap_stats` of the served tokens against the reference."""
    seqs, starts, served = _sequences(rids, finished, prompts, device)
    ref = reference_class(config["family"])(config["port"], config["quant"],
                                            seed, device)
    return gap_stats(ref.logits(seqs, starts), served)


def control_gaps(config: dict, seed: int, rids, finished, prompts,
                 device, act: str = "fp8") -> tuple[dict, dict]:
    """(`gap_stats` of the served tokens, `gap_stats` of the tokens the
    reference computed at ``act`` puts first), at the same positions,
    both in the reference's logits."""
    seqs, starts, served = _sequences(rids, finished, prompts, device)
    cls = reference_class(config["family"])
    ref = cls(config["port"], config["quant"], seed, device).logits(seqs,
                                                                    starts)
    low = cls(config["port"], config["quant"], seed, device,
              act=act).logits(seqs, starts)
    return (gap_stats(ref, served),
            gap_stats(ref, [lo.argmax(dim=-1) for lo in low]))
