"""diff_sal_tpu_torch: the PyTorch / CUDA port of diff_sal_tpu for NVIDIA
Hopper (H100).

A package of its own beside the JAX one: it imports torch, numpy, scipy
and einops and nothing of JAX or of `diff_sal_tpu`; PIL and cv2 only
inside the functions that decode or write images, pandas only inside
`metrics/offline.aggregate_results`. `python -m diff_sal_tpu_torch.cli`
is the command line. Layouts at public
functions are the JAX package's (channel-last, q/k/v as (B, L, H*D)),
parameter names are the reference's torch names (`bridge.py` carries flax
variables across). Entry points run on `cuda` unless given CPU tensors;
on CUDA every TPU kernel of the path is a hand-written Hopper kernel
(`ops/`, sources in `csrc/`), on the CPU its plain PyTorch version.
"""
