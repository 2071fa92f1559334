"""The fused attention backward (``csrc/flash_bwd.cu``): its launches'
bounds (five S x S x D products a head, counted once at the TF32 rate,
or bytes at the HBM rate) over their device time."""

from benchmark.counts import flash_bwd_counts
from benchmark.readers import flash_roofline_pct


def read(run):
    return flash_roofline_pct(run, "flash_bwd_kernel", flash_bwd_counts)
