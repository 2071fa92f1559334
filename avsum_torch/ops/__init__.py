"""Tensor ops of the port and the two hand-written CUDA kernels:

- :func:`avsum_torch.ops.melspec.fused_log_mel` (K1, ``csrc/melspec.cu``)
- :func:`avsum_torch.ops.attention.flash_attention` (K2, ``csrc/flash_fwd.cu``)
"""
