"""Operators of the port: plain PyTorch math, and the hand-written Hopper
kernels with their plain versions: K1, K5, K7, K12 and the f32 instances
(`attention`), K2 and K6 (`layernorm`), K3 (`mlp`, eval only), K4, K8, K9
and K10 (`resize`), K11 (`pool`). `kernels` builds and binds the CUDA
sources; `quant` holds the int8 MLP layers (no hand-written kernel: the
JAX package has no Pallas kernel there)."""
