"""Share of the profiled steps that carried prompt tokens (the
`prefill_tokens` counter moved), beside the device readings taken over
them; the rest decoded only."""
from perfbench import reduce


def read(run):
    return reduce.traced_prefill_share(run)
