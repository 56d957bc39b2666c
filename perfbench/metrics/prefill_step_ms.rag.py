"""Mean host time of the window's steps that carried prompt tokens
(the `prefill_tokens` counter moved), the profiled steps left out."""
from perfbench import reduce


def read(run):
    return reduce.step_ms(run, prefill_only=True)
