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
source): the same flash-MLP with every product in split TF32 on the
tensor cores (mma.sync m16n8k8, each operand a TF32 hi + lo pair, three
TF32 products, f32 sums flushed every two k-steps), which keeps f32's
accuracy at 2.5x FFMA's peak. A CTA of eight warps owns 32 rows: LN(y) in
f32 in shared memory, per hidden chunk (64 or 128 units) h = LN(y)
w1[chunk]^T, GELU into shared memory, out += GELU(h) w2[cols, chunk]^T
with the f32 sums in registers; w1 and w2 tiles arrive by cp.async into a
double buffer. At most 384 output columns per CTA (C = 768: two column
splits), and hidden splits into an f32 workspace where the grid is small,
as the bf16 plan does; `tail_f32_plan` gives the geometry. The JAX K3
takes f32 too, falling back to its reference where f32 weights exceed its
VMEM budget; here one instance serves every width.

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
    [K.P] * 10 + [K.I] * 3 + [K.F, K.I] + [K.I] * 4 + [K.P], replaces=KERNEL.replaces,
)

ACT_MODES = ("tanh", "exact")
MAX_C = 768
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
# the f32 instance's geometry, as csrc/mlp.cu has it
F32_ROWS = 32           # rows per CTA (FR)
F32_THREADS = 256       # eight warps (FTH)
F32_LD1 = 32 + 8        # row stride (floats) of a w1 tile of 32 input columns (FLD1)
F32_LD2 = 16 + 8        # and of a w2 tile of 16 hidden columns (FLD2)
F32_MAX_NC = 384        # output columns per CTA
F32_MAX_KSPLIT = 24
F32_WIDE_NT = (6, 12)   # nt that take hidden chunks of 128 (`f32_wide_chunks`)


def tail_f32_smem(C: int, nc: int, hc: int) -> int:
    """Dynamic shared memory of one f32-instance CTA (`tail_f32_smem` in
    csrc/mlp.cu): LN(y) (32 x (C + 8) floats), GELU(h) of a chunk (32 x
    (hc + 8)) and two weight tiles of max(hc x 40, nc x 24) floats."""
    return 4 * (F32_ROWS * (C + 8) + F32_ROWS * (hc + 8)
                + 2 * max(hc * F32_LD1, nc * F32_LD2))


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


@dataclasses.dataclass(frozen=True)
class TailF32Plan:
    """Geometry of one f32 K3 launch: CTAs of 32 rows (`row_tiles` over R)
    x `col_splits` column blocks of 32 `nt` output columns x `k_splits`
    hidden splits of `chunks` chunks of `hc` units, `ctas` in all; `smem`
    bytes. With k_splits > 1 the partial sums go to a (k_splits, R, C) f32
    workspace."""

    nt: int
    col_splits: int
    hc: int
    k_splits: int
    chunks: int
    smem: int
    row_tiles: int
    ctas: int


@functools.lru_cache(maxsize=None)  # the wrapper asks once per call, with few distinct shapes
def tail_f32_plan(R: int, C: int, Hd: int) -> TailF32Plan:
    """The f32 K3 geometry for R rows of width C and hidden Hd: the fewest
    column splits that keep a CTA at most F32_MAX_NC columns; a hidden
    split only where row tiles and column splits leave more than half of
    the CTA slots idle (the split's partial sums cost a pass through device
    memory), into the largest divisor of the chunk count (at most
    F32_MAX_KSPLIT) that keeps the CTAs within the slots (two per SM where
    shared memory lets two fit). The decoder's wide tails (nt 6 or 12)
    take chunks of 128 (four n-tiles per warp in the first product, half
    the chunk steps) where that still fills more than half of the slots.
    Raises ValueError on what the kernel does not take."""
    if C % 32 or not 32 <= C <= MAX_C:
        raise ValueError(f"block_tail: needs C % 32 == 0 and 32 <= C <= {MAX_C}, got {C}")
    if Hd % TAIL_CHUNK or Hd < TAIL_CHUNK:
        raise ValueError(f"block_tail: needs Hd % {TAIL_CHUNK} == 0, got {Hd}")
    if R < 1:
        raise ValueError(f"block_tail: R = {R}")
    col_splits = min(s for s in range(1, C // 32 + 1)
                     if C % (32 * s) == 0 and C // s <= F32_MAX_NC)
    nt = C // (32 * col_splits)
    row_tiles = _cdiv(R, F32_ROWS)
    base = row_tiles * col_splits

    def slots(hc):
        return NUM_SMS * max(1, min(2, SM_SMEM // (tail_f32_smem(C, 32 * nt, hc) + 1024)))

    def k_split(hc):
        return max(d for d in range(1, F32_MAX_KSPLIT + 1)
                   if (Hd // hc) % d == 0 and base * d <= slots(hc))
    wide = nt in F32_WIDE_NT and Hd % 128 == 0
    if 2 * base > slots(TAIL_CHUNK):
        hc, k_splits = (128 if wide else TAIL_CHUNK), 1
    else:
        hc, k_splits = TAIL_CHUNK, k_split(TAIL_CHUNK)
        if wide and 2 * base * k_split(128) > slots(128):
            hc, k_splits = 128, k_split(128)
    smem = tail_f32_smem(C, 32 * nt, hc)
    if smem > SMEM_MAX:
        raise ValueError(f"block_tail: C = {C} needs {smem} bytes of shared memory")
    return TailF32Plan(nt, col_splits, hc, k_splits, Hd // hc // k_splits, smem, row_tiles,
                       base * k_splits)


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
    for fc2, f32 accumulation, one rounding of the output (all in f64 for
    f64 inputs: the reference the f32 instance is measured against)."""
    dt = w1.dtype
    f = K.acc_dtype(skip.dtype)
    y = skip.to(f) + attn.to(f)
    C = y.shape[-1]
    mean = y.sum(-1, keepdim=True) / C
    var = ((y * y).sum(-1, keepdim=True) / C - mean * mean).clamp_min(0.0)
    xn = (y - mean) * torch.rsqrt(var + eps) * ln_w.to(f) + ln_b.to(f)
    h = xn.to(dt).to(f) @ w1.to(f).t() + b1.to(f)
    h = gelu(h, act_mode)
    o = h.to(dt).to(f) @ w2.to(f).t() + b2.to(f)
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
    K.refuse_dtensor("block_tail", *args)
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
        fp = tail_f32_plan(R, C, Hd)
        ws = (torch.empty((fp.k_splits, R, C), dtype=torch.float32, device=skip.device)
              if fp.k_splits > 1 else None)
        F32_KERNEL.launch(
            skip.data_ptr(), attn.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
            w1.data_ptr(), vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), R, C, Hd, float(eps),
            ACT_MODES.index(act_mode), fp.nt, fp.col_splits, fp.hc, fp.k_splits, K.stream(),
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
