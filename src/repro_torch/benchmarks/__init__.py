"""Benchmarks of the port, each writing its own JSON record."""
