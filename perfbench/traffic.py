"""The one traffic generator: reads a mix file (``traffic/<name>.json``)
and turns a seed into requests and arrivals.

Every seed gets the same set of sizes, in another order, and an open
loop the same arrivals, so that runs on different seeds do the same work.
A length distribution is cut into ``block`` equal-probability strata,
each block of consecutive requests holds one draw from every stratum (its
quantile midpoint), and the seed shuffles the order inside each block.
Arrivals are one realisation of a Poisson process: independent
exponential gaps drawn from the mix's ``arrival_seed``, whatever the run's
seed, so their bursts are the process's own. Token ids are uniform over
the vocabulary and drawn per request index, so a request's prompt does
not depend on the order in which the engine finished earlier ones.

A mix file holds:
  * ``loop``: ``"closed"`` (``clients`` callers, each sending its next
    request when the last one finished; each client's first request asks
    for a uniform share of its drawn output length, so completions spread
    out from the start) or ``"open"`` (arrivals at ``rate`` requests/s
    with independent exponential gaps drawn from ``arrival_seed``, after
    ``warmup_s`` seconds of the same arrivals);
  * ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
    "min", "max"}`` or ``{"dist": "uniform", "min", "max"}`` (inclusive);
  * ``engine``: the serving engine's settings for the cell;
  * ``trace_steps``: steps a traced run profiles; ``check``: the sample
    of finished requests held against the reference.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _quantile(spec: dict, u: float) -> int:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return min(hi, lo + int(u * (hi - lo + 1)))
    if spec["dist"] == "lognormal":
        v = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(u))
        return max(lo, min(hi, int(round(v))))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _strata(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


class Traffic:
    """Requests and arrivals of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.block = int(mix.get("block", 64))
        self._orders: dict[tuple[str, int], np.ndarray] = {}

    def _order(self, stream: str, b: int) -> np.ndarray:
        """The seed's shuffle of block ``b`` of one stream."""
        key = (stream, b)
        if key not in self._orders:
            tag = sum(ord(ch) << (8 * i) for i, ch in enumerate(stream[:6]))
            rng = np.random.default_rng([self.seed, tag, b])
            self._orders[key] = rng.permutation(self.block)
        return self._orders[key]

    def _stratum(self, stream: str, i: int) -> float:
        b, j = divmod(i, self.block)
        return float(_strata(self.block)[self._order(stream, b)[j]])

    def prompt_len(self, i: int) -> int:
        return _quantile(self.mix["prompt"], self._stratum("prompt", i))

    def output_len(self, i: int) -> int:
        return _quantile(self.mix["output"], self._stratum("output", i))

    def tokens(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 0x70726F6D, i])
        return rng.integers(0, self.vocab, self.prompt_len(i),
                            dtype=np.int64).astype(np.int32)

    def request(self, i: int) -> tuple[np.ndarray, int]:
        """Request ``i``: (prompt token ids, max new tokens)."""
        return self.tokens(i), self.output_len(i)

    def first_request(self, client: int) -> tuple[np.ndarray, int]:
        """A closed-loop client's first request: request ``client`` asking
        for a uniform share of its drawn output length."""
        toks, out = self.request(client)
        n = int(self.mix["clients"])
        rng = np.random.default_rng([self.seed, 0x6669, 0])
        u = float(_strata(n)[rng.permutation(n)[client]])
        return toks, max(1, int(math.ceil(u * out)))

    def gaps(self, n: int) -> np.ndarray:
        """Seconds between consecutive arrivals of an open loop, the first
        ``n``: independent exponentials of mean ``1 / rate`` from the
        mix's ``arrival_seed``, the same for every run seed."""
        rng = np.random.default_rng([int(self.mix["arrival_seed"]),
                                     0x676170])
        return rng.exponential(1.0 / float(self.mix["rate"]), n)

    def arrivals(self, horizon_s: float) -> list[float]:
        """Due offsets (seconds from the first arrival's zero) of every
        arrival before ``horizon_s``."""
        n = int(2 * float(self.mix["rate"]) * horizon_s) + 64
        t = np.cumsum(self.gaps(n))
        if t[-1] < horizon_s:
            raise ValueError("too few gaps drawn for the horizon")
        return [float(x) for x in t[t < horizon_s]]
