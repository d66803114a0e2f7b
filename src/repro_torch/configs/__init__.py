"""Workload configs of the paper."""
