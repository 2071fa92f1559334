"""Tensor ops of the port and its hand-written CUDA kernels:

- :func:`avsum_torch.ops.melspec.fused_log_mel` (K1, ``csrc/melspec.cu``)
- :func:`avsum_torch.ops.attention.flash_attention`: forward K2
  (``csrc/flash_fwd.cu``), the fused backward (``csrc/flash_bwd.cu``)
"""
