"""K2 (``csrc/flash_fwd.cu``): its launches' bounds (float32 operations
counted once at the TF32 rate, or bytes at the HBM rate, whichever is
larger) over their device time."""

from benchmark.counts import flash_fwd_counts
from benchmark.readers import flash_roofline_pct


def read(run):
    return flash_roofline_pct(run, "flash_fwd_kernel", flash_fwd_counts)
