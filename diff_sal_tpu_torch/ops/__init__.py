"""Operators of the port: plain PyTorch math, and the six hand-written
Hopper kernels with their plain versions: K1 and its backward K5
(`attention`), K2 and its backward K6 (`layernorm`), K3 (`mlp`, eval only)
and K4 (`resize`). `kernels` builds and binds the CUDA sources."""
