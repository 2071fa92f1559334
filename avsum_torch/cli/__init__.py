"""Command line: python -m avsum_torch.cli summarize VIDEO."""
