"""The KDA kernel's forward pass over chunks (``csrc/kda.cu``,
``kda_fwd_kernel``) in the hybrid decoder's step: its launches' bounds
(``counts_kda.pass_fwd_counts`` at a chunk of 64: float32 FLOPs counted
once at the TF32 rate, or the bytes read and written once at the HBM
rate) over their device time."""

from benchmark.counts_kda import kda_roofline_pct, pass_fwd_counts


def read(run):
    return kda_roofline_pct(run, "kda_fwd_kernel", pass_fwd_counts)
