"""Mean host time of an engine step over the window (ending in the
sampled tokens' copy to the host), the profiled steps left out."""
from perfbench import reduce


def read(run):
    return reduce.step_ms(run)
