"""K2 (``csrc/flash_fwd.cu``) in the decoder scorer's step: its launches'
bounds at the attentions' true widths (the MLA's q/k 192 and v 128, though
it runs them zero-padded to 256; the fusion's 256), float32 operations
counted once at the TF32 rate or bytes at the HBM rate, over their device
time."""

from benchmark.counts_decoder import attention_fwd_counts, flash_roofline_pct


def read(run):
    return flash_roofline_pct(run, "flash_fwd_kernel", attention_fwd_counts)
