"""The KDA kernel's backward pass over chunks (``csrc/kda.cu``,
``kda_bwd_kernel``) in the hybrid decoder's step: its launches' bounds
(``counts_kda.pass_bwd_counts`` at a chunk of 64) over their device
time."""

from benchmark.counts_kda import kda_roofline_pct, pass_bwd_counts


def read(run):
    return kda_roofline_pct(run, "kda_bwd_kernel", pass_bwd_counts)
