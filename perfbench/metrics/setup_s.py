"""Process start to the window's opening: weights, pools, warm-up,
the traffic's ramp, and any build of the kernels."""


def read(run):
    return run.spans.get("setup")
