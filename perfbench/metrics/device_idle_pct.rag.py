"""Share of the profiled window in which no operation ran on the device
(the profiler's device intervals, merged)."""
from perfbench import reduce


def read(run):
    return reduce.device_idle_pct(run)
