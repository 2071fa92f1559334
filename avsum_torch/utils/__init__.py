"""Host utilities: logging, profiling and debug helpers (no JAX)."""

from avsum_torch.utils.logging import JsonlLogger
from avsum_torch.utils.profiling import annotate

__all__ = ["JsonlLogger", "annotate"]
