"""Kernel K3: the fused transformer-block tail

    y = skip + attn;  out = y + fc2(gelu(fc1(LayerNorm(y))))

Replaces the TPU kernel `diff_sal_tpu/ops/mlp.py:132 fused_block_tail`
(body `_tail_kernel` :47), which the SalUNet decoder blocks run at eval.
Weights use the torch Linear layout: w1 (Hd, C), w2 (C, Hd).

On the H100 the tail is bound by operations at the decoder's widths
(4 * R * C * Hd flops with Hd = 2C, against three (R, C) row passes), so
the products run on the tensor cores. The kernel (`csrc/mlp.cu`) is a
"flash-MLP": a CTA of eight warps owns 32 rows, computes y and its
LayerNorm in f32 and keeps LN(y) in shared memory as bf16; it then walks
the hidden axis in chunks of 64, computing h = LN(y) w1[chunk]^T + b1 and
GELU in f32, and accumulates out += h w2[:, chunk]^T in f32 WMMA
fragments held in registers (the (R, Hd) hidden never reaches device
memory). The weights are read from L2 by every CTA rather than held
resident; the TPU kernel's "weights too big" fallback has no counterpart
here, since one kernel serves all four decoder widths (C = 96..768).

An f32 model runs K3's f32 instance (`dsal_block_tail_f32` in the same
source): the same tail with every product in f32 by FFMA on the CUDA
cores, 16 rows per CTA, w1 and w2 staged through shared memory in slices
(`f32_smem` gives its plan, within one CTA's shared memory for every
width up to MAX_C). The JAX K3 takes f32 too, falling back to its
reference where f32 weights exceed its VMEM budget; here one instance
serves every width.

K3 has no backward, in the JAX package or here: the decoder takes it only
at eval (JAX `sal_unet.py:387-391`, `fused_tail and not train`) and runs
the module path when training. `block_tail` raises when grad mode is on
and an input requires grad, rather than return a result that silently
has no gradient.
"""

from __future__ import annotations

import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "block_tail", "mlp.cu", "dsal_block_tail",
    [K.P] * 9 + [K.I] * 3 + [K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/mlp.py:132 fused_block_tail (_tail_kernel :47)",
)

F32_KERNEL = K.Kernel(
    "block_tail_f32", "mlp.cu", "dsal_block_tail_f32",
    [K.P] * 9 + [K.I] * 3 + [K.F, K.I, K.P], replaces=KERNEL.replaces,
)

ACT_MODES = ("tanh", "exact")
MAX_C = 768
F32_ROWS, F32_CHUNK = 16, 64  # rows per CTA and hidden units per chunk of the f32 instance
SMEM_MAX = 232_448


def f32_smem(C: int) -> int:
    """Shared memory of one f32-instance CTA (`smem_f32` in csrc/mlp.cu):
    LN(y) and a w2 slice (16 x C floats each), the hidden chunk (16 x 64)
    and a w1 slice (32 x 64)."""
    return (2 * F32_ROWS * C + F32_ROWS * F32_CHUNK + 32 * F32_CHUNK) * 4


def gelu(h: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tanh":
        return torch.nn.functional.gelu(h, approximate="tanh")
    if mode == "exact":
        return torch.nn.functional.gelu(h)
    raise ValueError(f"unknown activation mode {mode!r}")


def block_tail_plain(skip, attn, ln_w, ln_b, w1, b1, w2, b2, eps=1e-6,
                     act_mode="tanh"):
    """K3's plain version, rounding as the TPU kernel does: y in f32,
    LN(y) rounded to the weight dtype for fc1, GELU in f32, rounded again
    for fc2, f32 accumulation, one rounding of the output."""
    dt = w1.dtype
    y = skip.float() + attn.float()
    C = y.shape[-1]
    mean = y.sum(-1, keepdim=True) / C
    var = ((y * y).sum(-1, keepdim=True) / C - mean * mean).clamp_min(0.0)
    xn = (y - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    h = xn.to(dt).float() @ w1.float().t() + b1.float()
    h = gelu(h, act_mode)
    o = h.to(dt).float() @ w2.float().t() + b2.float()
    return (y + o).to(skip.dtype)


def block_tail(skip: torch.Tensor, attn: torch.Tensor, ln_w: torch.Tensor,
               ln_b: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-6,
               act_mode: str = "tanh") -> torch.Tensor:
    """skip/attn (R, C); w1 (Hd, C), w2 (C, Hd) in the compute dtype; LN
    and bias vectors any float dtype. Kernel K3 on CUDA (bf16 rows and
    weights, or its f32 instance for f32), the plain version on the CPU."""
    if act_mode not in ACT_MODES:
        raise ValueError(f"unknown activation mode {act_mode!r}")
    args = (skip, attn, ln_w, ln_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("block_tail (kernel K3) is eval-only and has no backward; "
                           "call it under torch.no_grad() or take the module path")
    if skip.device.type == "cpu":
        return block_tail_plain(skip, attn, ln_w, ln_b, w1, b1, w2, b2, eps, act_mode)
    K.require_cuda(skip, "block_tail")
    R, C = skip.shape
    Hd = w1.shape[0]
    K.check(tuple(attn.shape) == (R, C), "block_tail: attn shape != skip shape")
    K.check(tuple(w1.shape) == (Hd, C) and tuple(w2.shape) == (C, Hd),
            f"block_tail: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} for C={C}")
    dt = skip.dtype
    K.check(dt in (torch.bfloat16, torch.float32),
            f"block_tail: skip must be bfloat16 or float32 on the card, got {dt}")
    mult = 32 if dt == torch.float32 else 16
    K.check(C % mult == 0 and Hd % 64 == 0 and C <= MAX_C,
            f"block_tail: needs C % {mult} == 0, C <= {MAX_C}, Hd % 64 == 0 (C={C}, Hd={Hd})")
    for name, t in (("skip", skip), ("attn", attn), ("w1", w1), ("w2", w2)):
        K.check(t.dtype == dt, f"block_tail: {name} must be {dt}, got {t.dtype}")
        K.check(t.device == skip.device and t.is_contiguous(),
                f"block_tail: {name} must be contiguous, on {skip.device}")
    # the kernel loads weight fragments straight from global memory
    K.check(w1.data_ptr() % 32 == 0 and w2.data_ptr() % 32 == 0,
            "block_tail: weights must be 32-byte aligned")
    vecs = [p.float().contiguous() for p in (ln_w, ln_b, b1, b2)]
    out = torch.empty_like(skip)
    if R == 0:
        return out
    (F32_KERNEL if dt == torch.float32 else KERNEL).launch(
        skip.data_ptr(), attn.data_ptr(), *[p.data_ptr() for p in vecs[:2]], w1.data_ptr(),
        vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(), out.data_ptr(), R, C, Hd,
        float(eps), ACT_MODES.index(act_mode), K.stream(),
    )
    return out
