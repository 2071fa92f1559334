"""The fused attention backward (``csrc/flash_bwd.cu``) in the decoder
scorer's step: its launches' bounds at the attentions' true widths (three
S x S x Dqk and two S x S x Dv products a head; the MLA's 192 / 128 run
zero-padded to 256), over their device time."""

from benchmark.counts_decoder import attention_bwd_counts, flash_roofline_pct


def read(run):
    return flash_roofline_pct(run, "flash_bwd_kernel", attention_bwd_counts)
