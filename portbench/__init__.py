"""Benchmark of the PyTorch / CUDA port (see portbench/README.md)."""
