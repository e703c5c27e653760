"""Training utilities: logging and debugging helpers."""
