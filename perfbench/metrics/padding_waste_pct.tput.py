"""Padded share of the positions the scheduler dispatched over the
window (`scheduler_stats`: padded / dispatched positions)."""
from perfbench import reduce


def read(run):
    return reduce.padding_waste_pct(run)
