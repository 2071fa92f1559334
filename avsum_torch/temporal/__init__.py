"""Shot-boundary helpers and shot <-> annotation alignment (numpy)."""
