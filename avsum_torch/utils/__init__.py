"""Host utilities (no JAX)."""
