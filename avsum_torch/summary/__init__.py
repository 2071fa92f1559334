"""Knapsack summary selection (numpy)."""
