"""Frozen float32 operation counts, one module per model family."""
