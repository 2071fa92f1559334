"""Shot-boundary helpers (numpy)."""
