"""Deterministic synthetic token batches (a copy of the text-token branch
of the reference package's `data/pipeline.py`, numpy only: the same seed
and step give the same tokens and labels bit for bit).

Every batch is a pure function of ``(seed, step)`` (numpy Philox keyed on
both). The token stream is a vocab-reduced Markov chain rather than iid
uniform, so next-token entropy is below log V. `host_slice` cuts a
host's rows of the global batch, as the reference's does, and iterating
a dataset yields ``batch_at(0), batch_at(1), ...``. The reference's audio
and vision batches are not copied: the port runs text-only models.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticDataset:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        cfg, b, s = self.cfg, self.global_batch, self.seq_len
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.frontend} batches are not ported")
        rng = np.random.Generator(np.random.Philox(
            key=[np.uint64(self.seed), np.uint64(step)]))
        # Markov-ish token stream over a reduced alphabet: tok_{t+1} =
        # (a * tok_t + drift) mod A with occasional jumps — compressible.
        alpha = min(cfg.vocab_size, 4096)
        tok = np.empty((b, s + 1), np.int64)
        tok[:, 0] = rng.integers(0, alpha, b)
        jumps = rng.random((b, s)) < 0.1
        jump_to = rng.integers(0, alpha, (b, s))
        for t in range(s):
            nxt = (tok[:, t] * 31 + 7) % alpha
            tok[:, t + 1] = np.where(jumps[:, t], jump_to[:, t], nxt)
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}

    def host_slice(self, batch: dict, host_id: int, n_hosts: int) -> dict:
        per = self.global_batch // n_hosts
        return {k: v[host_id * per:(host_id + 1) * per]
                for k, v in batch.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0) -> SyntheticDataset:
    return SyntheticDataset(cfg, global_batch, seq_len, seed)
