"""Training examples from the feature cache (numpy)."""
