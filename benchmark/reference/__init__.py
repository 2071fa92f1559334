"""The benchmark's plain references: PyTorch and NumPy written out from
the published descriptions, importing nothing of the measured program."""
