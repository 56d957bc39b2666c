"""95th percentile over every gap between consecutive tokens of a
request, both inside the window."""
from perfbench import reduce


def read(run):
    return reduce.tail_ms(run.window.gaps())
