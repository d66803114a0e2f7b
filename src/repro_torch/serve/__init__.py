"""Serving: the LM wave engine, and the SpMM wave scheduler and engine."""
