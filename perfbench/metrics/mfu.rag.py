"""Useful FLOPs of the window's steps over the window at the card's bf16
peak (the frozen cost rules of `perfbench.costs`)."""
from perfbench import reduce


def read(run):
    return reduce.mfu_pct(run)
