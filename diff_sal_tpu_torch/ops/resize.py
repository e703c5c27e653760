"""Static-shape resizes, and kernel K4: the decoder's multi-scale
bilinear resize-and-sum.

Bilinear interpolation uses the half-pixel rule of
`torch.nn.functional.interpolate(mode='bilinear', align_corners=False)`
with edge clamp, written as one dense (out, in) matrix per axis
(`_linear_weights`, a copy of the JAX package's `ops/resize.py:23`).

K4 `bilinear_resize_sum(xs, out_hw)` = sum_i bilinear_resize(x_i, out_hw)
replaces the TPU kernel `diff_sal_tpu/ops/resize.py:235
bilinear_resize_sum` (body `_resize_sum_kernel` :206). On the H100 it is
bound by the bytes it writes: the (B, 112, 192, 768) output is ~2.5x
the four small inputs together, and it does ~16 multiply-adds per output
element. The kernel (`csrc/resize.cu` on `csrc/separable.cuh`) runs the
JAX body's two passes per CTA (b, a band of output rows, a chunk of C):
each input's rows interpolated into an f32 intermediate in shared memory
(each input row read once per band), then its columns from there into f32
registers, the output rounded once and written once. Tap rows, columns
and weights come from the same `_linear_weights` rule (lo, hi, 1-frac,
frac), so it matches the matrix form to rounding; `resize_plan` gives the
geometry.

K4 is differentiable: an autograd Function whose backward is plain math,
as in the JAX package (`op_bwd`, resize.py:310): d x_i = Ah_i^T g Aw_i^T in
f32, cast to x_i's dtype. The TPU has no kernel there, so neither does the
port.

K10 `bilinear_resize_add(acc, x)` = acc + bilinear_resize(x, acc's (H, W))
replaces the TPU kernel `diff_sal_tpu/ops/resize.py:142
bilinear_resize_add` (body `_resize_acc_kernel` :125). No model path calls
it (the decoder's sum is K4); it is K4's one-input form with a running
accumulator. Bound by bytes (acc read and the output written once, ~8
flops per element), it is K4's gather (`csrc/resize.cu`, entry
`dsal_resize_add`): the resized value summed in f32, rounded to acc's
dtype and added to acc in acc's dtype, as the TPU body rounds (:139). The
JAX kernel writes into acc's buffer (`input_output_aliases`); the port
always returns a fresh tensor and leaves acc as it was. It is an autograd
Function whose backward is the JAX `op_bwd` (:197) in plain math: d acc =
g, d x = Ah^T g Aw^T in f32, cast to x's dtype.

Two eval-only kernels compute the decoder head that follows the
resize-sum, relu(conv3x3_same(sum_i resize(x_i)) + b) with BatchNorm's
running statistics folded into the conv's kernel K' (3, 3, C, O) and
bias b (`models/layers.py:ConvBNRelu`):

K8 `resize_sum_conv_relu` replaces the TPU kernel
`diff_sal_tpu/ops/resize.py:388 resize_sum_conv_relu` (body
`_resize_sum_conv_kernel` :334), the head at full resolution. It is bound
by operations (9 C O multiply-adds per output pixel): the kernel
(`csrc/resize_conv.cu`) is an implicit GEMM on the tensor cores in which
the (H, W, C) sum never reaches device memory. In bf16, producer warps
gather the resize-sum of each 8 x 16 pixel tile with its halo, 32 channels
at a time (each input's pixels under the halo staged in shared memory),
round it to bf16 as the TPU kernel does for the MXU and hand it
through a two-stage shared-memory ring to a consumer warpgroup that runs
the nine shifted 3x3 taps as wgmma products with f32 accumulation (the
kernel slice by TMA from the kernel transposed to (9 O, C)). Its f32
instance (an f32 model's head; the TPU kernel computes in the input's
dtype) keeps the resize-sum in f32 and runs the products in split TF32 on
the tensor cores. `conv_plan` gives the geometry.

K9 `resize_sum_conv_relu_phase` replaces the TPU kernel
`diff_sal_tpu/ops/resize.py:567 resize_sum_conv_relu_phase` (body
`_phase_resize_head_kernel` :526), the same head as conv-at-low-res: u_i =
x_i K' at each task's resolution (a matmul outside the kernel, as in the
JAX package), then sum_i sum_dx Aw_dx (sum_dy Ah_dy u_i[dy, dx]) with the
dy-shifted resize matrices, + b and ReLU. The kernel
(`csrc/resize_phase.cu` on `csrc/separable.cuh`) is K4's two passes with
three shifts per axis: the dy contraction once per (output row, input
column, dx) into shared memory, rounded to u's dtype as the TPU kernel
rounds, then the dx contraction of every task in f32 registers;
`phase_plan` gives the geometry. Its plain version is
`resize_sum_conv_relu_lowres`, the JAX package's non-Pallas form.

Both raise when grad mode is on and an input requires grad: the JAX
package has no gradient for them either, and its training path keeps the
unfused ops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "bilinear_resize_sum", "resize.cu", "dsal_resize_sum",
    [K.P] * 4 + [K.P, K.P, K.P] + [K.I] * 4 + [K.I] * 4 + [K.I] * 11 + [K.P],
    replaces="diff_sal_tpu/ops/resize.py:235 bilinear_resize_sum "
             "(_resize_sum_kernel :206)",
)

ADD_KERNEL = K.Kernel(
    "bilinear_resize_add", "resize.cu", "dsal_resize_add",
    [K.P] * 5 + [K.I] * 8 + [K.P],
    replaces="diff_sal_tpu/ops/resize.py:142 bilinear_resize_add "
             "(_resize_acc_kernel :125)",
)

CONV_KERNEL = K.Kernel(
    "resize_conv_relu", "resize_conv.cu", "dsal_resize_conv_relu",
    [K.P] * 4 + [K.P] * 5 + [K.I] * 8 + [K.I] * 7 + [K.P],
    replaces="diff_sal_tpu/ops/resize.py:388 resize_sum_conv_relu "
             "(_resize_sum_conv_kernel :334)",
)
# K8's f32 instance: the same entry arguments, the kernel as (3, 3, C, O) f32
CONV_F32_KERNEL = K.Kernel(
    "resize_conv_relu_f32", "resize_conv.cu", "dsal_resize_conv_relu_f32",
    CONV_KERNEL.argtypes, replaces=CONV_KERNEL.replaces,
)
PHASE_KERNEL = K.Kernel(
    "resize_phase_head", "resize_phase.cu", "dsal_resize_phase_head",
    [K.P] * 4 + [K.P] * 4 + [K.I] * 8 + [K.I] * 11 + [K.P],
    replaces="diff_sal_tpu/ops/resize.py:567 resize_sum_conv_relu_phase "
             "(_phase_resize_head_kernel :526)",
)

MAX_INPUTS = 4
MAX_HEAD_OUT = 128  # O of the fused heads, as the TPU kernels take

# K8's geometry, as csrc/resize_conv.cu: 8 x 16 pixel tiles, a two-stage
# ring of 32-channel chunks (bf16: three dx-shifted copies of the 10 x 16
# halo rows, nine TMA boxes of the kernel slice), 16-channel chunks in f32
CONV_TILE = (8, 16)
CONV_KC = {torch.bfloat16: 32, torch.float32: 16}
CONV_THREADS = {torch.bfloat16: 384, torch.float32: 256}
CONV_WIDTHS = (32, 48, 64, 96, 128)  # the wgmma / n-tile widths the kernels take
CONV_STAGES = 2
CONV_TABLE_BYTES = MAX_INPUTS * (10 + 18) * 16
CONV_PATCH_BYTES = 128 * 80  # bf16: the inputs' pixels under a tile's halo, a chunk
SMEM_MAX = 232448
SM_SMEM = 233_472  # shared memory of an SM; each CTA also holds 1 KB
NUM_SMS = 132

# K4's and K9's geometry, as csrc/separable.cuh: persistent CTAs of 256
# threads, two per SM (a CTA's share of an SM's shared memory), each walking
# at least two work units where the shape has that many; strips of 4 output
# columns in the column pass, bands of 4, 2 or 1 output rows (the kernel's
# instances), staged tap pairs of 16 bytes, 48 small ints; channel chunks
# of 64 channels (K4) and 64 bytes (K9: 32 bf16, 16 f32, each the fastest
# on the card at the decoder's head) at most
SEP_THREADS = 256
SEP_STRIP = 4
SEP_BANDS = (4, 2, 1)
SEP_TAP_BYTES = 16
SEP_INT_BYTES = 48 * 4
SEP_TW_MAX = 256
SEP_CTAS_PER_SM = 2
SEP_SMEM = SM_SMEM // SEP_CTAS_PER_SM - 1024
SEP_UNITS_PER_CTA = 2
RESIZE_CHUNK = 64
PHASE_CHUNK_BYTES = 64


def conv_smem(np_: int, dtype: torch.dtype) -> int:
    """K8's dynamic shared memory for the padded width `np_`: bf16 1024
    bytes of alignment, two stages of the three 10 x 16-row dx copies of a
    32-channel chunk and the nine (np_, 32) kernel boxes, the mbarriers, the
    tap tables, the patches' bounds and two buffers of staged input pixels
    (128 of 80 bytes each); f32 the double-buffered 180-pixel halo (row
    stride 20 floats) and kernel slice (rows of np_ + 8 floats), the
    tables."""
    if dtype == torch.bfloat16:
        return 1024 + CONV_STAGES * (3 * 2 * 160 * 32 + 9 * np_ * 64) + 16 * CONV_STAGES \
            + CONV_TABLE_BYTES + MAX_INPUTS * 32 + 2 * CONV_PATCH_BYTES
    return 2 * 180 * 20 * 4 + 2 * 9 * 16 * (np_ + 8) * 4 + CONV_TABLE_BYTES


@dataclass(frozen=True)
class ConvPlan:
    """K8's launch: O padded to `np_` (the products' width), `chunks` of
    `kc` channels, a grid of (W / 16, H / 8, B) tiles of `threads`, `smem`
    bytes of shared memory each."""
    np_: int
    kc: int
    chunks: int
    grid: Tuple[int, int, int]
    threads: int
    smem: int


def conv_plan(B: int, H: int, W: int, C: int, O: int, dtype: torch.dtype) -> ConvPlan:
    """The K8 geometry for a (B, H, W) head of C inputs and O outputs;
    raises ValueError on what the kernels do not take."""
    if dtype not in CONV_KC:
        raise ValueError(f"resize_sum_conv_relu: dtype {dtype}, expected bf16 or f32")
    if min(B, H, W) < 1 or C < 16 or C % 16 or O < 16 or O % 16 or O > MAX_HEAD_OUT:
        raise ValueError(f"resize_sum_conv_relu: needs C % 16 == 0, O % 16 == 0, "
                         f"O <= {MAX_HEAD_OUT} (C={C}, O={O}, out {(B, H, W)})")
    np_ = min(w for w in CONV_WIDTHS if w >= O)
    kc = CONV_KC[dtype]
    th, tw = CONV_TILE
    return ConvPlan(np_, kc, -(-C // kc), (-(-W // tw), -(-H // th), B), CONV_THREADS[dtype],
                    conv_smem(np_, dtype))


def _taps(in_size: int, out_size: int):
    """(lo, hi, w_lo, w_hi) of the half-pixel rule, float64 coordinates."""
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = coords - lo
    return lo, hi, (1.0 - frac).astype(np.float32), frac.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out, in) interpolation matrix, half-pixel centres, edge clamp."""
    lo, hi, wl, wh = _taps(in_size, out_size)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    w[np.arange(out_size), lo] += wl
    w[np.arange(out_size), hi] += wh
    return w


def _matrix(in_size: int, out_size: int, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(_linear_weights(in_size, out_size)).to(device, dtype)


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the (H, W) axes of a (..., H, W, C) tensor; f32
    math, dtype preserved."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-3], x.shape[-2]
    lead = x.shape[:-3]
    f = K.acc_dtype(x.dtype)
    xf = x.to(f).reshape((-1,) + tuple(x.shape[-3:]))
    if in_h != out_h:
        xf = torch.einsum("oh,bhwc->bowc", _matrix(in_h, out_h, x.device, f), xf)
    if in_w != out_w:
        xf = torch.einsum("ow,bhwc->bhoc", _matrix(in_w, out_w, x.device, f), xf)
    return xf.reshape(tuple(lead) + (out_h, out_w, x.shape[-1])).to(x.dtype)


def linear_resize_1d(x: torch.Tensor, out_size: int, axis: int = 0) -> torch.Tensor:
    """1-D half-pixel linear resize along `axis`."""
    axis = axis % x.ndim
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    w = _matrix(in_size, out_size, x.device)
    y = torch.tensordot(w, x.float(), dims=([1], [axis]))
    return torch.movedim(y, 0, axis).to(x.dtype)


def nearest_upsample(x: torch.Tensor, factor: int, h_axis: int = -3,
                     w_axis: int = -2) -> torch.Tensor:
    """Integer-factor nearest upsample (a repeat along both axes)."""
    if factor == 1:
        return x
    x = torch.repeat_interleave(x, factor, dim=h_axis % x.ndim)
    return torch.repeat_interleave(x, factor, dim=w_axis % x.ndim)


def bilinear_resize_sum_plain(xs: Sequence[torch.Tensor],
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """K4's plain version: the f32 sum of the resized maps, cast once."""
    acc = None
    for x in xs:
        r = bilinear_resize(x.to(K.acc_dtype(x.dtype)), out_hw)
        acc = r if acc is None else acc + r
    return acc.to(xs[0].dtype)


@functools.lru_cache(maxsize=None)
def _tap_arrays(shapes: Tuple[Tuple[int, int], ...], out_hw):
    """Per input i: int32 [lo | hi] and f32 [w_lo | w_hi] rows of length
    H + W (rows first, then columns), stacked to (n, 2, H + W)."""
    H, W = out_hw
    idx = np.zeros((len(shapes), 2, H + W), np.int32)
    wts = np.zeros((len(shapes), 2, H + W), np.float32)
    for i, (h, w) in enumerate(shapes):
        for off, (a, b) in ((0, (h, H)), (H, (w, W))):
            lo, hi, wl, wh = _taps(a, b)
            idx[i, 0, off:off + b], idx[i, 1, off:off + b] = lo, hi
            wts[i, 0, off:off + b], wts[i, 1, off:off + b] = wl, wh
    return idx, wts


@functools.lru_cache(maxsize=None)
def _tap_tables(shapes: Tuple[Tuple[int, int], ...], out_hw, device):
    """`_tap_arrays` as tensors on `device`."""
    idx, wts = _tap_arrays(shapes, out_hw)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device))


def sep_smem(n: int, ns: int, bh: int, tw: int, cols: int, cc: int, mid_bytes: int) -> int:
    """A K4 / K9 CTA's dynamic shared memory: the tile's column tap pairs
    and the band's row tap pairs (n * ns each), the small ints, the (bh,
    cols, ns, cc) intermediate of `mid_bytes` elements, and the row
    windows' dense (bh, bh + 1) f32 weights per input and shift."""
    return ((n * ns * tw + n * ns * bh) * SEP_TAP_BYTES + SEP_INT_BYTES
            + bh * cols * ns * cc * mid_bytes + n * ns * bh * (bh + 1) * 4)


@dataclass(frozen=True)
class SepPlan:
    """K4's or K9's launch: work units of (a band of `bh` output rows, a
    chunk of `cc` channels, b, a tile of `tw` output columns), `cols` staged
    input columns per band row (the sum of `spans`: per input, the most
    columns the live taps of one tile reach), `smem` bytes a CTA, `ctas`
    persistent CTAs of SEP_THREADS walking the `units`."""
    bh: int
    cc: int
    tw: int
    cols: int
    spans: Tuple[int, ...]
    smem: int
    units: int
    ctas: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _spans(idx: np.ndarray, wts: np.ndarray, ns: int, H: int, W: int, tw: int):
    """Per input, the most input columns that the live column taps (weight
    non-zero) of one tile of `tw` output columns reach, over all shifts."""
    n = idx.shape[0]
    cols = idx[:, :, ns * H:].reshape(n, 2, ns, W).astype(np.int64)
    live = wts[:, :, ns * H:].reshape(n, 2, ns, W) != 0
    lo, hi = np.where(live, cols, np.iinfo(np.int64).max), np.where(live, cols, -1)
    spans = np.zeros(n, np.int64)
    for x0 in range(0, W, tw):
        a, b = lo[..., x0:x0 + tw].min(axis=(1, 2, 3)), hi[..., x0:x0 + tw].max(axis=(1, 2, 3))
        spans = np.maximum(spans, np.where(b >= a, b - a + 1, 0))
    return tuple(int(v) for v in spans)


def _sep_plan(B, H, W, C, idx, wts, ns, cc, V, mid_bytes) -> SepPlan:
    """Tiles as wide as the map (at most SEP_TW_MAX columns) and the widest
    band whose CTA fits two to an SM; narrower chunks, then narrower tiles
    where no band fits. Then thinner bands, then narrower chunks, while the
    persistent CTAs would walk fewer than SEP_UNITS_PER_CTA units each (the
    last units' tail)."""
    n = idx.shape[0]
    tw = min(W, SEP_TW_MAX)

    def halve(c):
        return max(V, c // 2 // V * V)

    while True:
        spans = _spans(idx, wts, ns, H, W, tw)
        cols = max(1, sum(spans))
        bands = [bh for bh in SEP_BANDS
                 if sep_smem(n, ns, bh, tw, cols, cc, mid_bytes) <= SEP_SMEM]
        if bands:
            break
        if cc > V:
            cc = halve(cc)
        elif tw > 1:
            tw = _cdiv(tw, 2)
        else:
            raise ValueError(f"no separable plan for out {(B, H, W, C)}")
    bh, tiles = bands[0], _cdiv(W, tw)
    slots = SEP_CTAS_PER_SM * NUM_SMS

    def units():
        return _cdiv(H, bh) * _cdiv(C, cc) * tiles * B

    while units() < SEP_UNITS_PER_CTA * slots and bh > 1:
        bh //= 2
    while units() < SEP_UNITS_PER_CTA * slots and cc > V:
        cc = halve(cc)
    smem = sep_smem(n, ns, bh, tw, cols, cc, mid_bytes)
    return SepPlan(bh, cc, tw, cols, spans, smem, units(), min(units(), slots))


@functools.lru_cache(maxsize=None)
def resize_plan(B: int, H: int, W: int, C: int, shapes: Tuple[Tuple[int, int], ...],
                dtype: torch.dtype) -> SepPlan:
    """K4's geometry for n <= 4 inputs of `shapes` summed into (B, H, W,
    C); raises ValueError on what the kernel does not take."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"resize_sum: dtype {dtype}, expected bf16 or f32")
    V = 8 if dtype == torch.bfloat16 else 4
    if (not 1 <= len(shapes) <= MAX_INPUTS or min(B, H, W) < 1 or C < V or C % V
            or min(min(s) for s in shapes) < 1):
        raise ValueError(f"resize_sum: no plan for {len(shapes)} inputs {shapes} into "
                         f"{(B, H, W, C)} (C % {V} == 0)")
    idx, wts = _tap_arrays(tuple(shapes), (H, W))
    return _sep_plan(B, H, W, C, idx, wts, 1, min(RESIZE_CHUNK, C), V, 4)


def bilinear_resize_sum_fwd(xs: Sequence[torch.Tensor],
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel K4 on CUDA, the plain version on the CPU; no autograd."""
    xs = list(xs)
    K.refuse_dtensor("bilinear_resize_sum", xs)
    if xs[0].device.type == "cpu":
        return bilinear_resize_sum_plain(xs, out_hw)
    K.require_cuda(xs[0], "bilinear_resize_sum")
    B, _, _, C = xs[0].shape
    dt = xs[0].dtype
    K.check(1 <= len(xs) <= MAX_INPUTS, f"resize_sum takes 1..{MAX_INPUTS} inputs")
    K.check(dt in (torch.bfloat16, torch.float32), f"resize_sum dtype {dt}")
    vec = 8 if dt == torch.bfloat16 else 4
    K.check(C % vec == 0, f"resize_sum needs C % {vec} == 0, got {C}")
    for x in xs:
        K.check(x.dim() == 4 and x.shape[0] == B and x.shape[3] == C
                and x.dtype == dt and x.device == xs[0].device
                and x.is_contiguous() and x.data_ptr() % 16 == 0,
                "resize_sum inputs: (B,h,w,C) contiguous, 16-byte aligned, one dtype")
    H, W = out_hw
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
    plan = resize_plan(B, H, W, C, shapes, dt)
    idx, wts = _tap_tables(shapes, (H, W), xs[0].device)
    out = torch.empty((B, H, W, C), dtype=dt, device=xs[0].device)
    ptrs = [x.data_ptr() for x in xs] + [None] * (MAX_INPUTS - len(xs))
    hs = [s[0] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    ws = [s[1] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    KERNEL.launch(
        *ptrs, idx.data_ptr(), wts.data_ptr(), out.data_ptr(), *hs, *ws,
        len(xs), B, H, W, C, plan.bh, plan.cc, plan.tw, plan.cols, plan.ctas,
        int(dt == torch.bfloat16), K.stream(),
    )
    return out


def bilinear_resize_sum_bwd(g: torch.Tensor, shapes, dtypes):
    """d x_i = Ah_i^T g Aw_i^T in f32, cast to x_i's dtype (JAX `op_bwd`)."""
    f = K.acc_dtype(g.dtype)
    H, W = g.shape[1], g.shape[2]
    return tuple(
        torch.einsum("ow,bhoc->bhwc", _matrix(w, W, g.device, f),
                     torch.einsum("oh,bowc->bhwc", _matrix(h, H, g.device, f), g.to(f))).to(dt)
        for (h, w), dt in zip(shapes, dtypes))


class _ResizeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_hw, *xs):
        ctx.shapes = [(x.shape[1], x.shape[2]) for x in xs]
        ctx.dtypes = [x.dtype for x in xs]
        return bilinear_resize_sum_fwd(xs, out_hw)

    @staticmethod
    def backward(ctx, g):
        return (None,) + bilinear_resize_sum_bwd(g, ctx.shapes, ctx.dtypes)


def bilinear_resize_sum(xs: Sequence[torch.Tensor],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """sum_i bilinear_resize(x_i, out_hw) for n <= 4 channel-last maps
    (B, h_i, w_i, C) of one dtype: K4 forward (plain on the CPU), plain
    backward."""
    return _ResizeSum.apply(tuple(out_hw), *xs)


def bilinear_resize_add_plain(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K10's plain version: x resized to acc's (H, W) in f32, rounded to
    acc's dtype, added to acc in acc's dtype."""
    r = bilinear_resize(x.to(K.acc_dtype(x.dtype)), tuple(acc.shape[1:3]))
    return acc + r.to(acc.dtype)


def bilinear_resize_add_fwd(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Kernel K10 on CUDA (acc and x bf16 or f32 each, C % 8 == 0), the
    plain version on the CPU; no autograd."""
    K.refuse_dtensor("bilinear_resize_add", acc, x)
    if acc.device.type == "cpu":
        return bilinear_resize_add_plain(acc, x)
    K.require_cuda(acc, "bilinear_resize_add")
    B, H, W, C = acc.shape
    for name, t in (("acc", acc), ("x", x)):
        K.check(t.dtype in (torch.bfloat16, torch.float32),
                f"bilinear_resize_add: {name} dtype {t.dtype}")
        K.check(t.dim() == 4 and t.shape[0] == B and t.shape[3] == C and t.device == acc.device
                and t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"bilinear_resize_add: {name} {tuple(t.shape)} must be (B, h, w, C) of acc's "
                "B and C, contiguous, 16-byte aligned")
    K.check(C % 8 == 0, f"bilinear_resize_add needs C % 8 == 0, got {C}")
    h, w = x.shape[1], x.shape[2]
    idx, wts = _tap_tables(((h, w),), (H, W), acc.device)
    out = torch.empty_like(acc)
    if out.numel():
        ADD_KERNEL.launch(acc.data_ptr(), x.data_ptr(), idx.data_ptr(), wts.data_ptr(),
                          out.data_ptr(), B, h, w, H, W, C, int(acc.dtype == torch.bfloat16),
                          int(x.dtype == torch.bfloat16), K.stream())
    return out


class _ResizeAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, x):
        ctx.shape, ctx.dtype = (x.shape[1], x.shape[2]), x.dtype
        return bilinear_resize_add_fwd(acc, x)

    @staticmethod
    def backward(ctx, g):
        return g, bilinear_resize_sum_bwd(g, [ctx.shape], [ctx.dtype])[0]


def bilinear_resize_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """acc + bilinear_resize(x, acc's (H, W)) for channel-last acc (B, H, W,
    C) and x (B, h, w, C): K10 forward (plain on the CPU), plain backward.
    Returns a new tensor; acc is not written."""
    return _ResizeAdd.apply(acc, x)


# --------------------------------------------------------------- heads -----


def _check_eval_only(name: str, *ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} is eval-only and has no backward; call it under "
                           "torch.no_grad() or take the unfused head")


def _check_head_inputs(name, xs, kernel, bias, dtypes):
    K.require_cuda(xs[0], name)
    B, _, _, C = xs[0].shape
    dt = xs[0].dtype
    O = kernel.shape[-1]
    K.check(1 <= len(xs) <= MAX_INPUTS, f"{name} takes 1..{MAX_INPUTS} inputs")
    K.check(dt in dtypes, f"{name}: dtype {dt}, expected one of {dtypes}")
    for x in xs:
        K.check(x.dim() == 4 and x.shape[0] == B and x.shape[3] == C and x.dtype == dt
                and x.device == xs[0].device and x.is_contiguous() and x.data_ptr() % 16 == 0,
                f"{name} inputs: (B,h,w,C) contiguous, 16-byte aligned, one dtype")
    K.check(tuple(kernel.shape) == (3, 3, C, O) and kernel.dtype == dt
            and kernel.device == xs[0].device and kernel.is_contiguous(),
            f"{name}: kernel {tuple(kernel.shape)} {kernel.dtype}; expected (3, 3, {C}, O) "
            f"{dt}, contiguous")
    K.check(tuple(bias.shape) == (O,) and bias.device == xs[0].device,
            f"{name}: bias {tuple(bias.shape)} for O={O}")
    return B, C, O, dt


def resize_sum_conv_relu_plain(xs: Sequence[torch.Tensor], out_hw: Tuple[int, int],
                               kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K8's plain version, rounding as the TPU kernel does: the f32
    resize-sum rounded to the kernel's dtype, the 3x3 'same' conv with f32
    accumulation, f32 bias, ReLU, one rounding to x's dtype."""
    f = K.acc_dtype(xs[0].dtype)
    acc = None
    for x in xs:
        r = bilinear_resize(x.to(f), out_hw)
        acc = r if acc is None else acc + r
    a = acc.to(kernel.dtype).to(f).permute(0, 3, 1, 2)
    y = torch.nn.functional.conv2d(a, kernel.to(f).permute(3, 2, 0, 1), None, 1, 1)
    y = torch.relu(y.permute(0, 2, 3, 1) + bias.to(f))
    return y.to(xs[0].dtype)


def resize_sum_conv_relu(xs: Sequence[torch.Tensor], out_hw: Tuple[int, int],
                         kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3_same(sum_i bilinear_resize(x_i, out_hw)) + bias) for n
    <= 4 maps (B, h_i, w_i, C), kernel (3, 3, C, O) with any eval-time
    affine folded in, bias (O,): kernel K8 on CUDA (bf16, or f32 through
    its f32 instance; C % 16 == 0, O % 16 == 0, O <= 128), the plain
    version on the CPU. Eval only."""
    xs = list(xs)
    K.refuse_dtensor("resize_sum_conv_relu", xs, kernel, bias)
    _check_eval_only("resize_sum_conv_relu (kernel K8)", *xs, kernel, bias)
    if xs[0].device.type == "cpu":
        return resize_sum_conv_relu_plain(xs, out_hw, kernel, bias)
    B, C, O, dt = _check_head_inputs("resize_sum_conv_relu", xs, kernel, bias,
                                     (torch.bfloat16, torch.float32))
    H, W = out_hw
    plan = conv_plan(B, H, W, C, O, dt)
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
    idx, wts = _tap_tables(shapes, (H, W), xs[0].device)
    b = bias.float().contiguous()
    out = torch.empty((B, H, W, O), dtype=dt, device=xs[0].device)
    if dt == torch.bfloat16:
        # tap-major rows of output channels, C contiguous: the products' B
        # operand as the TMA boxes read it
        kern, entry = kernel.permute(0, 1, 3, 2).reshape(9 * O, C).contiguous(), CONV_KERNEL
    else:
        kern, entry = kernel, CONV_F32_KERNEL
    ptrs = [x.data_ptr() for x in xs] + [None] * (MAX_INPUTS - len(xs))
    hs = [s[0] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    ws = [s[1] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    entry.launch(
        *ptrs, idx.data_ptr(), wts.data_ptr(), kern.data_ptr(), b.data_ptr(), out.data_ptr(),
        *hs, *ws, len(xs), B, H, W, C, O, plan.np_, K.stream(),
    )
    return out


def _head_matrix(kernel: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(3dy, 3dx, C, O) -> (C, 9 O) with (dy, dx, O)-ordered columns."""
    C, O = kernel.shape[2], kernel.shape[3]
    return kernel.to(dt).permute(2, 0, 1, 3).reshape(C, 9 * O)


def resize_sum_conv_relu_lowres(xs: Sequence[torch.Tensor], out_hw: Tuple[int, int],
                                kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K9's plain version, the JAX package's `resize_sum_conv_relu_lowres`
    (resize.py:483): u_i = x_i K' (f32 accumulation, rounded to x's
    dtype), the dy-shifted row matrices and the dx-shifted column matrices
    in x's dtype, the dy contraction rounded to x's dtype, the dx
    contraction and the task sum in f32, f32 bias, ReLU, one rounding."""
    TH, TW = out_hw
    dt = xs[0].dtype
    f = K.acc_dtype(dt)
    C, O = kernel.shape[2], kernel.shape[3]
    kf = _head_matrix(kernel, dt).to(f)
    acc = None
    for x in xs:
        B, h, w, _ = x.shape
        u = (x.reshape(-1, C).to(f) @ kf).to(dt).to(f).reshape(B, h, w, 3, 3 * O)
        ah = np.pad(_linear_weights(h, TH), ((1, 1), (0, 0)))
        aw = np.pad(_linear_weights(w, TW), ((1, 1), (0, 0)))
        mat = lambda a: torch.from_numpy(a).to(x.device, dt).to(f)  # noqa: E731
        v = sum(torch.einsum("oh,bhwk->bowk", mat(ah[dy:dy + TH]), u[:, :, :, dy])
                for dy in range(3))
        v = v.to(dt).to(f).reshape(B, TH, w, 3, O)
        y = sum(torch.einsum("pw,bowc->bopc", mat(aw[dx:dx + TW]), v[:, :, :, dx])
                for dx in range(3))
        acc = y if acc is None else acc + y
    return torch.relu(acc + bias.to(f)).to(dt)


@functools.lru_cache(maxsize=None)
def _phase_arrays(shapes: Tuple[Tuple[int, int], ...], out_hw, dtype):
    """Per input i: int32 [lo | hi] and f32 [w_lo | w_hi] of the shifted
    resize matrices, weights rounded to `dtype`; entry dy * TH + o is row o
    of Ah_dy, entry 3 TH + dx * TW + p row p of Aw_dx; zero weights where
    the shifted row falls past the border."""
    TH, TW = out_hw
    L = 3 * (TH + TW)
    idx = np.zeros((len(shapes), 2, L), np.int32)
    wts = np.zeros((len(shapes), 2, L), np.float32)
    for i, (h, w) in enumerate(shapes):
        for base, (n_in, n_out) in ((0, (h, TH)), (3 * TH, (w, TW))):
            lo, hi, wl, wh = _taps(n_in, n_out)
            for d in range(3):
                src = np.arange(n_out) + d - 1
                ok = (src >= 0) & (src < n_out)
                at = base + d * n_out + np.arange(n_out)[ok]
                idx[i, 0, at], idx[i, 1, at] = lo[src[ok]], hi[src[ok]]
                wts[i, 0, at], wts[i, 1, at] = wl[src[ok]], wh[src[ok]]
    wts = torch.from_numpy(wts).to(dtype).float().numpy()  # the TPU kernel's bf16 matrices
    return idx, wts


@functools.lru_cache(maxsize=None)
def _phase_tables(shapes: Tuple[Tuple[int, int], ...], out_hw, dtype, device):
    """`_phase_arrays` as tensors on `device`."""
    idx, wts = _phase_arrays(shapes, out_hw, dtype)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


@functools.lru_cache(maxsize=None)
def phase_plan(B: int, TH: int, TW: int, shapes: Tuple[Tuple[int, int], ...], O: int,
               dtype: torch.dtype) -> SepPlan:
    """K9's geometry for n <= 4 tasks of `shapes` into (B, TH, TW, O);
    raises ValueError on what the kernel does not take."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"resize_sum_conv_relu_phase: dtype {dtype}, expected bf16 or f32")
    V = 8 if dtype == torch.bfloat16 else 4
    if (not 1 <= len(shapes) <= MAX_INPUTS or min(B, TH, TW) < 1 or O < V or O % V
            or O > MAX_HEAD_OUT or min(min(s) for s in shapes) < 1):
        raise ValueError(f"resize_sum_conv_relu_phase: no plan for {len(shapes)} tasks {shapes} "
                         f"into {(B, TH, TW, O)} (O % {V} == 0, O <= {MAX_HEAD_OUT})")
    idx, wts = _phase_arrays(tuple(shapes), (TH, TW), dtype)
    size = 2 if dtype == torch.bfloat16 else 4
    return _sep_plan(B, TH, TW, O, idx, wts, 3, min(PHASE_CHUNK_BYTES // size, O), V, size)


def resize_sum_conv_relu_phase(xs: Sequence[torch.Tensor], out_hw: Tuple[int, int],
                               kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3_same(sum_i bilinear_resize(x_i, out_hw)) + bias) as
    conv-at-low-res: u_i = x_i K' by torch.matmul, then kernel K9 on CUDA
    (bf16 or f32, O % 8 == 0 (bf16) or O % 4 == 0 (f32), O <= 128), the
    plain version on the CPU. Eval only."""
    xs = list(xs)
    K.refuse_dtensor("resize_sum_conv_relu_phase", xs, kernel, bias)
    _check_eval_only("resize_sum_conv_relu_phase (kernel K9)", *xs, kernel, bias)
    if xs[0].device.type == "cpu":
        return resize_sum_conv_relu_lowres(xs, out_hw, kernel, bias)
    B, C, O, dt = _check_head_inputs("resize_sum_conv_relu_phase", xs, kernel, bias,
                                     (torch.bfloat16, torch.float32))
    vec = 8 if dt == torch.bfloat16 else 4
    K.check(O % vec == 0 and O <= MAX_HEAD_OUT,
            f"resize_sum_conv_relu_phase: needs O % {vec} == 0 and O <= {MAX_HEAD_OUT}, "
            f"got {O}")
    TH, TW = out_hw
    kf = _head_matrix(kernel, dt)
    us = [torch.matmul(x.reshape(-1, C), kf).reshape(x.shape[0], x.shape[1], x.shape[2], 9 * O)
          for x in xs]
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
    plan = phase_plan(B, TH, TW, shapes, O, dt)
    idx, wts = _phase_tables(shapes, (TH, TW), dt, xs[0].device)
    b = bias.float().contiguous()
    out = torch.empty((B, TH, TW, O), dtype=dt, device=xs[0].device)
    ptrs = [u.data_ptr() for u in us] + [None] * (MAX_INPUTS - len(us))
    hs = [s[0] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    ws = [s[1] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    PHASE_KERNEL.launch(
        *ptrs, idx.data_ptr(), wts.data_ptr(), b.data_ptr(), out.data_ptr(), *hs, *ws,
        len(xs), B, TH, TW, O, plan.bh, plan.cc, plan.tw, plan.cols, plan.ctas,
        int(dt == torch.bfloat16), K.stream(),
    )
    return out
