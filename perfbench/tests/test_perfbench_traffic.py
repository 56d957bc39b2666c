"""The traffic generator: deterministic from the seed, the same sizes for
every seed in another order, an open loop's arrivals a Poisson process
that every seed shares, and every mix inside its engine's limits."""
import json
from collections import Counter

import numpy as np
import pytest

from conftest import ROOT
from perfbench.traffic import Traffic

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))


def mix(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = Traffic(mix(name), 2**31 + 11, 151936), Traffic(mix(name),
                                                           2**31 + 11, 151936)
    for i in range(0, 300, 37):
        ta, oa = a.request(i)
        tb, ob = b.request(i)
        assert oa == ob and np.array_equal(ta, tb)
    if mix(name)["loop"] == "open":
        assert a.arrivals(20.0) == b.arrivals(20.0)
    else:
        assert [a.first_request(c)[1] for c in range(8)] == \
            [b.first_request(c)[1] for c in range(8)]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sizes_in_another_order(name):
    m = mix(name)
    n = m["block"] * 3
    a, b = Traffic(m, 1, 1000), Traffic(m, 2**31 + 5, 1000)
    pa = [a.prompt_len(i) for i in range(n)]
    pb = [b.prompt_len(i) for i in range(n)]
    assert Counter(pa) == Counter(pb) and pa != pb
    assert Counter(a.output_len(i) for i in range(n)) == \
        Counter(b.output_len(i) for i in range(n))
    if m["loop"] == "open":
        assert a.arrivals(60.0) == b.arrivals(60.0)


@pytest.mark.parametrize("name", [n for n in MIXES
                                  if mix(n)["loop"] == "open"])
def test_open_loop_arrivals_are_poisson(name):
    """Independent exponential gaps: the count in windows of a few seconds
    spreads as a Poisson count does (variance about its mean), where gaps
    stratified in blocks would hold it near constant."""
    m = mix(name)
    t = Traffic(m, 2**31 + 3, 1000)
    rate, span, horizon = m["rate"], 3.0, 3000.0
    arr = np.asarray(t.arrivals(horizon))
    assert len(arr) / horizon == pytest.approx(rate, rel=0.03)
    counts = np.histogram(arr, bins=np.arange(0.0, horizon + 1e-9, span))[0]
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.15)
    g = np.diff(arr)
    # memoryless: the gap after a short gap is as long as after a long one
    short = g[1:][g[:-1] < np.median(g)]
    long_ = g[1:][g[:-1] >= np.median(g)]
    assert short.mean() == pytest.approx(long_.mean(), rel=0.1)
    # a prefix of a longer horizon is the shorter horizon's arrivals
    assert t.arrivals(30.0) == [x for x in t.arrivals(60.0) if x < 30.0]


@pytest.mark.parametrize("name", MIXES)
def test_sizes_fit_the_engine(name):
    m = mix(name)
    t = Traffic(m, 7, 151552)
    e = m["engine"]
    for i in range(m["block"]):
        toks, out = t.request(i)
        assert m["prompt"]["min"] <= len(toks) <= m["prompt"]["max"]
        assert m["output"]["min"] <= out <= m["output"]["max"]
        assert len(toks) + out - 1 <= e["max_seq"]
        assert toks.dtype == np.int32 and 0 <= toks.min() \
            and toks.max() < 151552
    if m["loop"] == "closed":
        shares = [t.first_request(c)[1] / t.request(c)[1]
                  for c in range(m["clients"])]
        assert 0 < min(shares) and max(shares) <= 1.0
        assert np.mean(shares) == pytest.approx(0.5, abs=0.05)


def test_medians_follow_the_mix():
    m = mix("chat256")
    t = Traffic(m, 3, 1000)
    lens = [t.prompt_len(i) for i in range(m["block"])]
    assert abs(np.median(lens) - m["prompt"]["median"]) <= 0.05 * \
        m["prompt"]["median"]
