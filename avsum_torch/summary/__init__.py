"""Knapsack summary selection and evaluation metrics (numpy)."""
