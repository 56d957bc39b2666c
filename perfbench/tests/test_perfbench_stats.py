"""Rates and tails over every sample of the window, a stall included."""
import statistics

import numpy as np
import pytest

from perfbench import stats


def test_percentile_matches_numpy_over_all_values():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = list(rng.exponential(size=n))
        for q in (50, 90, 95, 99):
            assert stats.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)))
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_quartile_spread_uses_statistics_quantiles():
    xs = [10.0, 11.0, 9.5, 10.5, 10.2, 9.9]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.quartile_spread(xs) == pytest.approx((q3 - q1) / med)


def _window():
    w = stats.Window(t_open=10.0, t_close=20.0)
    # a request in flight at the opening: tokens before it are not counted
    w.reqs[0] = stats.Req(due=5.0, times=[9.0, 9.5, 10.5, 11.0])
    # due inside, first token at 12: TTFT 1 s; a 5 s stall between tokens
    w.reqs[1] = stats.Req(due=11.0, times=[12.0, 12.5, 17.5, 18.0])
    # due inside, never served by the close: counts with its wait so far
    w.reqs[2] = stats.Req(due=16.0, times=[])
    # due inside, first token after the close: the same
    w.reqs[3] = stats.Req(due=19.0, times=[20.5])
    # due after the close: not in the window
    w.reqs[4] = stats.Req(due=20.5, times=[21.0])
    return w


def test_rate_counts_every_token_inside_the_window():
    w = _window()
    assert w.tokens() == 2 + 4
    assert w.seconds == 10.0


def test_ttft_counts_unserved_requests_with_their_wait():
    assert _window().ttfts() == pytest.approx({1: 1.0, 2: 4.0, 3: 1.0})


def test_gaps_take_every_gap_a_stall_included():
    gaps = sorted(_window().gaps())
    assert gaps == pytest.approx([0.5, 0.5, 0.5, 5.0])
    # the stall is the tail: a per-request maximum would hide the others
    assert stats.percentile(gaps, 95) > 4.0
