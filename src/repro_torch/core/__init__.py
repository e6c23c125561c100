"""Hashing, the PageStore layout, the HashMem structure and probe dispatch."""
