"""Kernel K3: the fused transformer-block tail

    y = skip + attn;  out = y + fc2(gelu(fc1(LayerNorm(y))))

Replaces the TPU kernel `diff_sal_tpu/ops/mlp.py:132 fused_block_tail`
(body `_tail_kernel` :47), which the SalUNet decoder blocks run at eval.
Weights use the torch Linear layout: w1 (Hd, C), w2 (C, Hd).

On the H100 the tail is bound by operations at the decoder's widths
(8 * R * C^2 flops with Hd = 2C, against three (R, C) row passes), so
the products run on the tensor cores and the (R, Hd) hidden never reaches
device memory. The kernel (`csrc/mlp.cu`) is a Hopper "flash-MLP": a CTA
owns 64 rows, computes y and LN(y) in f32 and keeps LN(y) in shared
memory as bf16; a warpgroup walks the hidden axis in chunks of 64,
h = LN(y) w1[chunk]^T by `wgmma` from shared memory, h + b1 and GELU in
registers, rounded to bf16 as the register operand of out += GELU(h)
w2[cols, chunk]^T, also a `wgmma`. w1 and w2 arrive as 64x64 tiles by TMA
through a ring of shared-memory buffers behind mbarriers. A CTA owns at
most four 64-column output tiles (its f32 accumulator in registers), so
wide tails split the output columns over CTAs; where rows and column
splits leave SMs idle (C = 768 at the decoder's first stage), CTAs also
split the hidden axis and a second kernel adds their f32 partial sums in
a fixed order (no atomics: deterministic). Where the CTAs are about one
per SM (C = 384 and 768), two consumer warpgroups split a CTA's hidden
chunks and add their partial sums through shared memory. `tail_plan`
chooses the geometry on the host, so the CPU tests reach it. The TPU kernel's
"weights too big" fallback has no counterpart here: one kernel serves all
four decoder widths (C = 96..768).

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

import dataclasses
import functools

import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "block_tail", "mlp.cu", "dsal_block_tail",
    [K.P] * 10 + [K.I] * 3 + [K.F, K.I] + [K.I] * 5 + [K.P],
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
# the bf16 kernel's geometry, as csrc/mlp.cu has it
NUM_SMS = 132
SM_SMEM = 233_472       # shared memory of one SM; each CTA reserves 1 KB of it
TAIL_ROWS = 64          # rows per CTA (one warpgroup)
TAIL_CHUNK = 64         # hidden units per chunk
TAIL_TILE = 8192        # one ring buffer: a 64 x 64 bf16 weight tile
TAIL_MAX_NT = 4         # 64-column output tiles per CTA
TAIL_MAX_STAGES = 8
TAIL_MAX_KSPLIT = 8
TAIL_STAGES = {1: 4, 2: 8}  # ring buffers by consumer warpgroups per CTA


def f32_smem(C: int) -> int:
    """Shared memory of one f32-instance CTA (`smem_f32` in csrc/mlp.cu):
    LN(y) and a w2 slice (16 x C floats each), the hidden chunk (16 x 64)
    and a w1 slice (32 x 64)."""
    return (2 * F32_ROWS * C + F32_ROWS * F32_CHUNK + 32 * F32_CHUNK) * 4


def tail_smem(C: int, stages: int) -> int:
    """Dynamic shared memory of one bf16 K3 CTA (`tail_smem` in
    csrc/mlp.cu): LN(y) (64 x C bf16), `stages` weight tiles and their
    mbarriers, 1024 bytes to align the base."""
    return TAIL_ROWS * C * 2 + stages * (TAIL_TILE + 8) + 1024


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """Geometry of one bf16 K3 launch: CTAs of `rows` rows (`row_tiles`
    of them over R) x `nt` 64-column output tiles (`col_splits` over C) x
    `chunks` hidden chunks of 64 (`k_splits` over Hd), `ctas` in all, each
    with `wgs` consumer warpgroups that share its chunks; w1 tiles of `kb`
    32-column boxes; `stages` ring buffers (split evenly between the
    warpgroups); `smem` bytes. With k_splits > 1 the partial sums go to a
    (k_splits, R, C) f32 workspace."""

    rows: int
    nt: int
    kb: int
    col_splits: int
    k_splits: int
    chunks: int
    wgs: int
    stages: int
    smem: int
    row_tiles: int
    ctas: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)  # the wrapper asks once per call, with few distinct shapes
def tail_plan(R: int, C: int, Hd: int) -> TailPlan:
    """The bf16 K3 geometry for R rows of width C and hidden Hd. The output
    tiles of C split over the fewest CTAs that keep each at most four
    tiles, evenly; the hidden axis splits over CTAs only where row tiles
    and column splits leave more than half of the SMs idle (the split's
    partial sums cost a pass through device memory), into the largest
    divisor of the chunk count (at most 8) that keeps one CTA per SM
    (measured: fewer, fuller CTAs beat a second wave of short ones).
    Where the CTAs are few (at most two per SM) two warpgroups share a
    CTA's chunks;
    else one, with a smaller ring so that more CTAs fit on an SM. Raises
    ValueError on what the kernel does not take."""
    if C % 32 or not 32 <= C <= MAX_C:
        raise ValueError(f"block_tail: needs C % 32 == 0 and 32 <= C <= {MAX_C}, got {C}")
    if Hd % TAIL_CHUNK or Hd < TAIL_CHUNK:
        raise ValueError(f"block_tail: needs Hd % {TAIL_CHUNK} == 0, got {Hd}")
    if R < 1:
        raise ValueError(f"block_tail: R = {R}")
    tiles = _cdiv(C, 64)
    nt = max(d for d in range(1, TAIL_MAX_NT + 1) if tiles % d == 0)
    col_splits = tiles // nt
    row_tiles = _cdiv(R, TAIL_ROWS)
    n_chunks = Hd // TAIL_CHUNK
    base = row_tiles * col_splits
    k_splits = 1
    if 2 * base <= NUM_SMS:
        k_splits = max(d for d in range(1, TAIL_MAX_KSPLIT + 1)
                       if n_chunks % d == 0 and base * d <= NUM_SMS)
    chunks = n_chunks // k_splits
    # two warpgroups where the CTAs are about one per SM (each issues its
    # own chain of products; measured on the H100: C = 768 and 384 at the
    # decoder's rows 1.5-1.7x faster, PERF.md), with eight ring buffers,
    # four each; else one warpgroup with four buffers, so that more CTAs
    # fit on an SM
    wgs = 2 if base * k_splits <= 2 * NUM_SMS and chunks >= 2 else 1
    stages = TAIL_STAGES[wgs]
    # the epilogue stages the f32 sums (64 x 64 nt) where LN(y) and the ring were
    if (tail_smem(C, stages) > SMEM_MAX
            or TAIL_ROWS * nt * 64 * 4 > TAIL_ROWS * C * 2 + stages * TAIL_TILE):
        raise ValueError(f"block_tail: C = {C} leaves no room for the weight ring")
    return TailPlan(TAIL_ROWS, nt, 2 if C % 64 == 0 else 1, col_splits, k_splits, chunks, wgs,
                    stages, tail_smem(C, stages), row_tiles, row_tiles * col_splits * k_splits)


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
    dt = skip.dtype
    if tuple(attn.shape) != (R, C):
        raise ValueError("block_tail: attn shape != skip shape")
    if tuple(w1.shape) != (Hd, C) or tuple(w2.shape) != (C, Hd):
        raise ValueError(f"block_tail: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} for C={C}")
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block_tail: skip must be bfloat16 or float32 on the card, got {dt}")
    # the four row and weight tensors: one dtype, contiguous, on skip's card
    # and 16-byte aligned (TMA and vector loads); messages built only on failure
    for name, t in (("skip", skip), ("attn", attn), ("w1", w1), ("w2", w2)):
        if t.dtype != dt:
            raise ValueError(f"block_tail: {name} must be {dt}, got {t.dtype}")
        if not (t.device == skip.device and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"block_tail: {name} must be contiguous, 16-byte aligned, on "
                             f"{skip.device}")
    vecs = [p.float().contiguous() for p in (ln_w, ln_b, b1, b2)]
    out = torch.empty_like(skip)
    if R == 0:
        return out
    if dt == torch.float32:
        if C % 32 or Hd % 64 or C > MAX_C:
            raise ValueError(f"block_tail: needs C % 32 == 0, C <= {MAX_C}, Hd % 64 == 0 "
                             f"(C={C}, Hd={Hd})")
        F32_KERNEL.launch(
            skip.data_ptr(), attn.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w1.data_ptr(), vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(),
            out.data_ptr(), R, C, Hd, float(eps), ACT_MODES.index(act_mode), K.stream(),
        )
        return out
    plan = tail_plan(R, C, Hd)
    ws = (torch.empty((plan.k_splits, R, C), dtype=torch.float32, device=skip.device)
          if plan.k_splits > 1 else None)
    KERNEL.launch(
        skip.data_ptr(), attn.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(),
        vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), R, C, Hd, float(eps), ACT_MODES.index(act_mode),
        plan.nt, plan.col_splits, plan.k_splits, plan.wgs, plan.stages, K.stream(),
    )
    return out
