"""Plain references, one module per model family."""
