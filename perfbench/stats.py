"""Rates and tails over every sample of a window, by the host clock.

A request is timed from when it was due (an open loop's schedule, or a
closed loop's submission); one that has no first token when the window
closes counts with its wait so far, so a stall inside the window lifts
the tail instead of dropping out of it.
"""
from __future__ import annotations

import dataclasses
import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the closest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, the quartiles as `statistics.quantiles(values,
    n=4)` gives them: the spread the benchmark's bounds are set from."""
    import statistics
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


@dataclasses.dataclass
class Req:
    due: float                     # host clock the request was due at
    times: list = dataclasses.field(default_factory=list)  # token times
    finished: float | None = None  # host clock its last token came back


@dataclasses.dataclass
class Window:
    """What the measured window saw, on the host clock."""
    t_open: float
    t_close: float = 0.0
    steps: list = dataclasses.field(default_factory=list)
    # per step: (start, end, tokens emitted, prompt tokens run)
    reqs: dict = dataclasses.field(default_factory=dict)   # rid -> Req

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def tokens(self) -> int:
        """Output tokens emitted inside the window."""
        return sum(1 for r in self.reqs.values() for t in r.times
                   if self.t_open < t <= self.t_close)

    def ttfts(self) -> dict:
        """Request id -> seconds from due to first token, for every request
        due inside the window; a request without a first token by the close
        counts with its wait so far."""
        out = {}
        for rid, r in self.reqs.items():
            if not self.t_open <= r.due < self.t_close:
                continue
            first = r.times[0] if r.times else None
            if first is None or first > self.t_close:
                out[rid] = self.t_close - r.due
            else:
                out[rid] = first - r.due
        return out

    def gaps(self) -> list[float]:
        """Every gap between consecutive tokens of a request, both inside
        the window."""
        out = []
        for r in self.reqs.values():
            ts = [t for t in r.times if self.t_open < t <= self.t_close]
            out += [b - a for a, b in zip(ts, ts[1:])]
        return out
