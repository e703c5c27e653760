"""Data and tensor parallelism over torch.distributed (JAX package
`parallel/`)."""
