"""Correctness phase, performance phase and the benchmark CLI."""
