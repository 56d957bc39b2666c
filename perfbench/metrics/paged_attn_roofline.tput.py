"""K2 (paged_attention_chunk over int8 pages): the sum of its calls'
roofline bounds over its device time in the profiled steps."""
from perfbench import reduce


def read(run):
    return reduce.paged_attn_roofline_pct(run)
