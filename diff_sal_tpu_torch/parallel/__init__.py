"""Data parallelism over torch.distributed (JAX package `parallel/`)."""
