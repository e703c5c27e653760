"""Kernels K2 and K6: row LayerNorm over the last axis with f32
statistics, and its backward.

K2 replaces the TPU kernel `diff_sal_tpu/ops/layernorm.py:134
fused_layernorm` (body `_ln_kernel` :39). The function: mean and E[x^2]
in f32, var = E[x^2] - mean^2 clamped at 0, rsqrt(var + eps), then scale
and bias, output in the input dtype. `real_dim` normalizes over the first
`real_dim` channels of a zero-padded axis and keeps the padded channels at
zero.

On the H100 it is bound by bytes: one read and one write of the rows
against ~8 flops per element. The kernel (`csrc/layernorm.cu`) keeps many
bytes in flight per SM: persistent CTAs (at most two per SM) walk tiles of
consecutive rows; thread 0 copies each tile, one contiguous byte range,
with one bulk copy into a ring of up to four shared-memory buffers behind
mbarriers; the threads read rows as 16-byte vectors, a power-of-two group
of lanes per row (4 lanes at C = 96 bf16, a warp at C = 768), reduce the
two sums by shuffles inside the group, keep w and b in registers for the
whole CTA and write 16-byte vectors. `ln_plan` chooses the tile rows,
stages and grid on the host, so the CPU tests reach it; the C entry
refuses a plan that does not match its input. Rows the bulk copy cannot
take (a byte length not a multiple of 16, or a pointer not 16-byte
aligned) run a warp-per-row kernel from the same entry, one K2 launch all
the same.

K6 replaces the TPU kernel `diff_sal_tpu/ops/layernorm.py:283 _ln_bwd`
(body `_ln_bwd_kernel` :233): dx with the row statistics recomputed, and
the f32 sums d_weight = sum_rows g * y and d_bias = sum_rows g. It is
bound by bytes too (read x and g, write dx). The kernel
(`csrc/layernorm_bwd.cu`) is K2's design with two inputs: persistent CTAs
bulk-copy tiles of x and g into one ring, lane groups read 16-byte
vectors, dx leaves as 16-byte stores, and each lane keeps w and its
running per-channel sums of g * y and g in registers. A CTA adds its
lanes' sums (shuffles, then shared memory) into one (2C,) partial row,
and a small second kernel adds the CTAs' rows in a fixed order, the CTA
axis spread over eight warps per 32 columns. No atomics, so the parameter
gradients do not depend on scheduling. `ln_bwd_plan` chooses tile rows,
stages and grid on the host; the C entry refuses a plan that does not
match its input, and takes a warp-per-row kernel exactly where the bulk
copy cannot. CUDA rather than Triton, to keep the route of the other
kernels (nvcc -> shared library -> ctypes, built in seconds).

`layer_norm` is differentiable: on either device it is an autograd
Function whose forward is K2 (plain on the CPU) and whose backward is K6
(plain on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "layer_norm", "layernorm.cu", "dsal_layernorm",
    [K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.F, K.I, K.I, K.I, K.I, K.P],
    replaces="diff_sal_tpu/ops/layernorm.py:134 fused_layernorm (_ln_kernel :39)",
)
BWD_KERNEL = K.Kernel(
    "layer_norm_bwd", "layernorm_bwd.cu", "dsal_layernorm_bwd",
    [K.P] * 6 + [K.I] * 3 + [K.F] + [K.I] * 4 + [K.P],
    replaces="diff_sal_tpu/ops/layernorm.py:283 _ln_bwd (_ln_bwd_kernel :233)",
)

MAX_C = 1024

# K2's geometry, as csrc/layernorm.cu has it
NUM_SMS = 132
SMEM_MAX = 232_448
SM_SMEM = 233_472       # shared memory of one SM; each CTA reserves 1 KB of it
LN_THREADS = 256
LN_MAX_VALUES = 32      # values per lane (C <= 32 lanes * 32)
LN_MAX_STAGES = 4
LN_CTAS_PER_SM = 2      # the kernel's launch bound
LN_TILE_BYTES = 16_384  # the tile size aimed at
LN_ROWS_PER_CTA = 8     # the row kernel: one warp per row
CARD_DTYPES = (torch.bfloat16, torch.float32)
# K6's geometry, as csrc/layernorm_bwd.cu has it (threads, values per lane,
# stages, two CTAs per SM and the row kernel's rows as K2's)
BWD_TILE_BYTES = 8192   # the tile size aimed at, per input (x and g share a stage)
BWD_WARPS = LN_THREADS // 32
BWD_MAX_GRID = NUM_SMS * LN_CTAS_PER_SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LnPlan:
    """Geometry of one K2 launch (`csrc/layernorm.cu`).

    Bulk path (`bulk`): `group` lanes per row, `vpl` 16-byte vectors per
    lane, tiles of `tile_rows` rows (`tiles` in all) walked by `grid`
    persistent CTAs through a ring of `stages` buffers, `smem` dynamic
    shared-memory bytes. Row kernel (not `bulk`): tile_rows = 0, one warp
    per row, `grid` CTAs of LN_ROWS_PER_CTA rows."""

    bulk: bool
    group: int
    vpl: int
    tile_rows: int
    stages: int
    smem: int
    tiles: int
    grid: int


@functools.lru_cache(maxsize=None)  # the wrapper asks once per call, with few distinct shapes
def ln_plan(R: int, C: int, dtype: torch.dtype, aligned: bool = True) -> LnPlan:
    """K2's launch for R rows of C channels of `dtype` (`aligned`: x's
    address is a multiple of 16). Tiles of about LN_TILE_BYTES, smaller
    where that leaves a CTA slot of the card without a tile; as many ring
    stages as a CTA has tiles, up to four and as two CTAs per SM leave
    room for. Raises ValueError on what no
    path of the kernel takes."""
    if dtype not in CARD_DTYPES:
        raise ValueError(f"layer_norm: dtype {dtype} (the kernel takes bf16 and f32)")
    if not 1 <= C <= MAX_C or R < 1:
        raise ValueError(f"layer_norm: needs 1 <= C <= {MAX_C} and R >= 1, got R={R}, C={C}")
    size = 2 if dtype == torch.bfloat16 else 4
    row_bytes = C * size
    if not aligned or row_bytes % 16:
        blocks = _cdiv(R, LN_ROWS_PER_CTA)
        return LnPlan(False, 32, 0, 0, 0, 0, blocks, blocks)
    nvec = row_bytes // 16
    per_lane = LN_MAX_VALUES // (16 // size)  # vectors a lane may hold
    group = 1
    while group * per_lane < nvec:
        group *= 2
    vpl = _cdiv(nvec, group)
    step = LN_THREADS // group  # rows of a tile in flight at once
    slots = NUM_SMS * LN_CTAS_PER_SM
    cap = step * max(1, LN_TILE_BYTES // (step * row_bytes))
    tile_rows = min(cap, step * _cdiv(_cdiv(R, slots), step))
    tiles = _cdiv(R, tile_rows)
    grid = min(tiles, slots)
    # no deeper than a CTA has tiles, and two CTAs' rings on one SM
    room = (SM_SMEM // LN_CTAS_PER_SM - 1024) // (tile_rows * row_bytes + 8)
    stages = min(LN_MAX_STAGES, _cdiv(tiles, grid), room)
    smem = stages * tile_rows * row_bytes + 8 * stages
    if smem > SMEM_MAX:
        raise ValueError(f"layer_norm: a tile of {tile_rows} rows of {row_bytes} bytes "
                         f"needs more than {SMEM_MAX} bytes of shared memory")
    return LnPlan(True, group, vpl, tile_rows, stages, smem, tiles, grid)


@dataclasses.dataclass(frozen=True)
class LnBwdPlan:
    """Geometry of one K6 launch (`csrc/layernorm_bwd.cu`): K2's fields
    (`LnPlan`; `smem` also holds the warps' sums). The row kernel (not
    `bulk`) runs `grid` CTAs of LN_ROWS_PER_CTA warps, a warp per row,
    striding over the rows. With grid > 1 the CTAs' (grid, 2C) partial
    rows go to the reduction kernel."""

    bulk: bool
    group: int
    vpl: int
    tile_rows: int
    stages: int
    smem: int
    tiles: int
    grid: int


def bwd_red_bytes(C: int) -> int:
    """The warps' sums, BWD_WARPS x 2C floats (`red_bytes` in the source)."""
    return 4 * BWD_WARPS * 2 * C


@functools.lru_cache(maxsize=None)  # the wrapper asks once per call, with few distinct shapes
def ln_bwd_plan(R: int, C: int, dtype: torch.dtype, aligned: bool = True) -> LnBwdPlan:
    """K6's launch for R rows of C channels of `dtype` (`aligned`: x, g and
    dx all at multiples of 16 bytes). K2's rule (`ln_plan`) with two inputs
    per stage and BWD_TILE_BYTES per input. Raises ValueError on what no
    path of the kernel takes."""
    if dtype not in CARD_DTYPES:
        raise ValueError(f"layer_norm_bwd: dtype {dtype} (the kernel takes bf16 and f32)")
    if not 1 <= C <= MAX_C or R < 1:
        raise ValueError(f"layer_norm_bwd: needs 1 <= C <= {MAX_C} and R >= 1, got R={R}, "
                         f"C={C}")
    size = 2 if dtype == torch.bfloat16 else 4
    row_bytes = C * size
    if not aligned or row_bytes % 16:
        grid = min(_cdiv(R, LN_ROWS_PER_CTA), BWD_MAX_GRID)
        return LnBwdPlan(False, 32, 0, 0, 0, bwd_red_bytes(C), grid, grid)
    nvec = row_bytes // 16
    per_lane = LN_MAX_VALUES // (16 // size)
    group = 1
    while group * per_lane < nvec:
        group *= 2
    vpl = _cdiv(nvec, group)
    step = LN_THREADS // group
    cap = step * max(1, BWD_TILE_BYTES // (step * row_bytes))
    tile_rows = min(cap, step * _cdiv(_cdiv(R, BWD_MAX_GRID), step))
    tiles = _cdiv(R, tile_rows)
    grid = min(tiles, BWD_MAX_GRID)
    stage = 2 * tile_rows * row_bytes
    room = (SM_SMEM // LN_CTAS_PER_SM - 1024) // (stage + 8)
    stages = max(1, min(LN_MAX_STAGES, _cdiv(tiles, grid), room))
    smem = max(stages * stage, bwd_red_bytes(C)) + 8 * stages
    if smem > SMEM_MAX:
        raise ValueError(f"layer_norm_bwd: a tile of {tile_rows} rows of {row_bytes} bytes "
                         f"needs more than {SMEM_MAX} bytes of shared memory")
    return LnBwdPlan(True, group, vpl, tile_rows, stages, smem, tiles, grid)


def _padded(p: torch.Tensor, C: int) -> torch.Tensor:
    p = p.to(K.acc_dtype(p.dtype))
    if p.shape[0] < C:
        p = torch.nn.functional.pad(p, (0, C - p.shape[0]))
    return p


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """K2's plain version."""
    C = x.shape[-1]
    w, b = _padded(weight, C), _padded(bias, C)
    c_real = real_dim or C
    xf = x.to(K.acc_dtype(x.dtype))
    mean = xf.sum(-1, keepdim=True) / c_real
    var = ((xf * xf).sum(-1, keepdim=True) / c_real - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if real_dim is not None and real_dim < C:
        lane = torch.arange(C, device=x.device)
        y = torch.where(lane < real_dim, y, torch.zeros((), device=x.device))
    return (y * w.to(xf.dtype) + b.to(xf.dtype)).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                         eps: float = 1e-6, real_dim: Optional[int] = None):
    """K6's plain version: (dx, dweight, dbias) as the TPU kernel computes
    them. Row statistics in f32; with real_dim < C the pad lanes of dx get
    the mean coupling dmean / c_real (not 0), as in the JAX package; dx in
    x's dtype; dweight and dbias are f32 sums over rows at the parameter's
    length."""
    C = x.shape[-1]
    n_param = weight.shape[0]
    c_real = real_dim or C
    f = K.acc_dtype(x.dtype)
    xf = x.reshape(-1, C).to(f)
    gf = g.reshape(-1, C).to(f)
    s = _padded(weight, C).to(f)
    mask = (torch.arange(C, device=x.device) < c_real).to(f)
    mean = xf.sum(-1, keepdim=True) / c_real
    var = ((xf * xf).sum(-1, keepdim=True) / c_real - mean * mean).clamp_min(0.0)
    r = torch.rsqrt(var + eps)
    u = xf - mean
    y = u * r * mask
    dy = gf * s * mask
    sum_dy = dy.sum(-1, keepdim=True)
    dvar = -0.5 * (r * r * r) * (dy * u).sum(-1, keepdim=True)
    dmean = -r * sum_dy - 2.0 * mean * dvar
    dx = dy * r + (2.0 / c_real) * xf * dvar + dmean / c_real
    return (dx.reshape(x.shape).to(x.dtype), (gf * y).sum(0)[:n_param],
            gf.sum(0)[:n_param])


def _check_rows(name: str, x: torch.Tensor, real_dim):
    """(rows, C) of x, or ValueError. The messages are built only on
    failure: the wrappers check on every launch, and on the host-bound
    paths that time counts."""
    C = x.shape[-1]
    if x.dtype not in CARD_DTYPES:
        raise ValueError(f"{name} dtype {x.dtype}")
    if C > MAX_C:
        raise ValueError(f"{name} needs C <= {MAX_C}, got {C}")
    if not x.is_contiguous():
        raise ValueError(f"{name} input must be contiguous")
    if real_dim is not None and not 0 < real_dim <= C:
        raise ValueError(f"real_dim {real_dim} vs C {C}")
    return x.numel() // C, C


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """Kernel K2 on CUDA, the plain version on the CPU; no autograd."""
    K.refuse_dtensor("layer_norm", x, weight, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, real_dim)
    K.require_cuda(x, "layer_norm")
    R, C = _check_rows("layer_norm", x, real_dim)
    w = _padded(weight, C).contiguous()
    b = _padded(bias, C).contiguous()
    out = torch.empty_like(x)
    if R == 0:
        return out
    plan = ln_plan(R, C, x.dtype, x.data_ptr() % 16 == 0)
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), R, C, real_dim or C,
        float(eps), int(x.dtype == torch.bfloat16), plan.tile_rows, plan.stages, plan.grid,
        K.stream(),
    )
    return out


def layer_norm_bwd(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6, real_dim: Optional[int] = None):
    """(dx, dweight, dbias) of `layer_norm`: kernel K6 on CUDA, the plain
    version on the CPU."""
    K.refuse_dtensor("layer_norm_bwd", x, g, weight)
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, g, weight, eps, real_dim)
    K.require_cuda(x, "layer_norm_bwd")
    R, C = _check_rows("layer_norm_bwd", x, real_dim)
    if not (g.shape == x.shape and g.dtype == x.dtype and g.is_contiguous()
            and g.device == x.device):
        raise ValueError("layer_norm_bwd: g must be contiguous, of x's shape, dtype and device")
    n_param = weight.shape[0]
    w = _padded(weight, C).contiguous()
    dx = torch.empty_like(x)
    if R == 0:
        return dx, torch.zeros(n_param, device=x.device), torch.zeros(n_param, device=x.device)
    plan = ln_bwd_plan(R, C, x.dtype, x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
                       and dx.data_ptr() % 16 == 0)
    dwb = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    part = (torch.empty((plan.grid, 2 * C), dtype=torch.float32, device=x.device)
            if plan.grid > 1 else None)
    BWD_KERNEL.launch(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(),
        None if part is None else part.data_ptr(), dwb.data_ptr(), R, C, real_dim or C,
        float(eps), int(x.dtype == torch.bfloat16), plan.tile_rows, plan.stages, plan.grid,
        K.stream(),
    )
    return dx, dwb[:n_param], dwb[C:C + n_param]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, real_dim):
        ctx.save_for_backward(x, weight)
        ctx.args = (eps, real_dim, bias.dtype)
        return layer_norm_fwd(x, weight, bias, eps, real_dim)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        eps, real_dim, bias_dtype = ctx.args
        dx, dw, db = layer_norm_bwd(x, g.contiguous(), weight, eps, real_dim)
        return dx, dw.to(weight.dtype), db.to(bias_dtype), None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """LayerNorm over the last axis: K2 forward, K6 backward (plain versions
    on the CPU). weight/bias are (C,) or (real_dim,)."""
    return _LayerNorm.apply(x, weight, bias, eps, real_dim)
