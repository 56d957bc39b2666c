"""Deterministic synthetic batches (a copy of the reference package's
`data/pipeline.py`, numpy only: the same seed and step give the same
batch element for element).

Every batch is a pure function of ``(seed, step)`` (numpy Philox keyed on
both), drawn from one stream in the reference's order. The token stream
is a vocab-reduced Markov chain rather than iid uniform, so next-token
entropy is below log V. An audio config (hubert) gets band-limited noise
as its stub frame features ``[B, S, frontend_dim]`` and random codeword
labels (drawn: phase, frequency, noise, labels); a vision config
(phi-3-vision) gets the token stream and then unit-normal stub patch
embeddings ``[B, num_patches, frontend_dim]``, which the model prepends
(its labels align to the text). `host_slice` cuts a host's rows of the
global batch, as the reference's does, and iterating a dataset yields
``batch_at(0), batch_at(1), ...``.
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
        rng = np.random.Generator(np.random.Philox(
            key=[np.uint64(self.seed), np.uint64(step)]))
        if cfg.frontend == "audio":
            t = np.arange(s)[None, :, None]
            phase = rng.uniform(0, 2 * np.pi, (b, 1, cfg.frontend_dim))
            freq = rng.uniform(0.01, 0.3, (b, 1, cfg.frontend_dim))
            feats = (np.sin(freq * t + phase)
                     + 0.1 * rng.standard_normal((b, s, cfg.frontend_dim)))
            labels = rng.integers(0, cfg.vocab_size, (b, s))
            return {"features": feats.astype(np.float32),
                    "labels": labels.astype(np.int32)}
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
        batch = {"tokens": tok[:, :-1].astype(np.int32),
                 "labels": tok[:, 1:].astype(np.int32)}
        if cfg.frontend == "vision":
            batch["images"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        return batch

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
