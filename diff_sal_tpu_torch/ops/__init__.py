"""Operators of the port: plain PyTorch math, and the four hand-written
Hopper kernels (K1 `attention`, K2 `layernorm`, K3 `mlp`, K4 `resize`)
with their plain versions. `kernels` builds and binds the CUDA sources."""
