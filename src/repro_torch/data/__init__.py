"""Workload generators (numpy only)."""
