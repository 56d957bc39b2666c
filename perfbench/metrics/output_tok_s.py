"""Every output token emitted in the window over the window's seconds."""
from perfbench import reduce


def read(run):
    return reduce.output_tok_s(run)
