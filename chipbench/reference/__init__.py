"""The plain references, one module per model family."""
