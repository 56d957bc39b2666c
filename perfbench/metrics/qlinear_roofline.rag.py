"""K1 (awq_matmul) and K3 (awq_gateup): the sum of their calls' roofline
bounds over their device time in the profiled steps."""
from perfbench import reduce


def read(run):
    return reduce.qlinear_roofline_pct(run)
