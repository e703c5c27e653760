"""Kernels K1 and K5: pooled attention with the decomposed (T, H, W)
rel-pos bias and residual pooling, for MViT's spatial query rows, and its
backward.

K1 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:601
fused_bias_attention_v2` (body `_attn_v2_kernel` :477). Per head:

    out = softmax(q k^T * scale + bias) v  (+ q when `residual`)
    bias[l, j] = rel_t[l, t(j)] + rel_h[l, h(j)] + rel_w[l, w(j)]  for j >= 1

with (t, h, w) = unravel(j - 1) over the (kt, kh, kw) key grid and zero
bias for key 0, the cls token. Layouts as in the JAX package: q (B, Lq,
H*D) holds the spatial rows only, k and v (B, Lk, H*D) carry cls at row 0,
Lk = 1 + kt*kh*kw. rel is (B, Lq, H, kt + kh + kw), unpadded (the TPU pads
each head to 128 lanes).

On the H100 the work is dominated by the two products (4*Lq*Lk*D flops
per head; Lq = 43008, Lk = 673 at block 0, Lk = 2689 at block 1), well
above the bytes of q, k, v, rel and out, so it is bound by operations.
The kernel (`csrc/attention.cu`) is a warp-specialised Hopper forward: a
producer warpgroup keeps TMA loads of Q (once) and of K/V tiles (a ring of
`stages` buffers behind mbarriers) in flight; one or two consumer
warpgroups of 64 query rows each run S = Q K^T and O += P V with `wgmma`
(bf16 in, f32 accumulated in registers), add the bias from a per-row table
of rel_t + rel_h and rel_w in shared memory, and keep the online softmax,
P and O in registers. `fwd_plan` chooses the geometry on the host, so the
CPU tests reach it: 128 rows per CTA (two consumer warpgroups) with 64-key
tiles where that fills the card, else 64 rows with 128-key tiles. TMA
zero-fills rows past L, so nothing is padded; key columns past Lk get
-inf. When the caller asks (the autograd Function, when a gradient will
be taken), the kernel also writes each row's logsumexp in f32 for the
backward. head_dim is 96 at every MViT stage (64 and 128 are taken too).

K5 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:761 _fba2_bwd`
(body `_attn_v2_bwd_kernel` :697): dq, dk, dv and drel of K1 from the
output gradient g. It recomputes p = exp(s - lse) from the logsumexp the
forward saved (the score matrix is never stored) and is bound by
operations: five (Lq, Lk, D) products per head, ~10*Lq*Lk*D flops. The
kernels (`csrc/attention_bwd.cu`) take the forward's Hopper machinery: TMA
loads (Q, G, K, V tiles) and bulk copies into mbarrier rings, issued one
tile ahead by one thread, and every product a `wgmma` of the CTA's one
warpgroup, two CTAs per SM. A q-major kernel,
one CTA per (batch, head, 64 query rows), walks the key tiles twice: delta
= rowsum(dp * p) (the TPU's delta, which keeps the plain version's
rounding points; FlashAttention's rowsum(g * o) would need o, which exists
only rounded inside out = o + q), then ds in registers, dq += ds_lo k and
drel += ds E^T with E each tile's one-hot (key -> t, h, w) matrix, as the
TPU kernel does (ds as bf16 hi + lo parts, f32 accumulation). It writes
dq and drel once, and each row's rel terms, lse and delta as one padded
f32 row for the second part. A k-major kernel, one CTA per (batch, head,
64 keys, q split), streams its split of the query tiles and accumulates dk
and dv in registers; the splits (enough CTAs to fill the card where Lk is
small) go to an f32 workspace and a small kernel sums them in a fixed
order, so no atomics touch device memory and two runs give the same bits.
`bwd_plan` mirrors the geometry and shared memory on the host.

`bias_attention` is differentiable: on either device it is an autograd
Function whose forward is K1 (plain on the CPU) and whose backward is K5
(plain on the CPU); the forward's logsumexp is saved between them.

Every wrapper takes bf16 or f32 on the card, routed by q's dtype: bf16 to
the Hopper kernels above, f32 (both packages' default compute dtype) to
their f32 instances, which round nowhere in between, as the plain versions
do at f32. The f32 forward (`csrc/attention_f32_fwd.cu`) runs on the tensor
cores in split TF32: each operand x = hi + lo with hi rounded to TF32 and
lo = x - hi, and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b (mma.sync
m16n8k8, f32 sums), which keeps about f32's accuracy at up to 495 / 3
TFLOP/s (`csrc/tf32.cuh`); `f32_fwd_plan` mirrors its geometry. The f32
backward (`csrc/attention_f32.cu`) runs its products the same way: a
q-major kernel (dq, drel, delta; two passes over the key tiles) and a
k-major one (dk, dv over query splits, reduced in a fixed order), drel as
ds times the one-hot (key -> bin) matrix on the tensor cores; `f32_bwd_plan`
mirrors its geometry. K7's f32 instance (`csrc/cvt_attention.cu`) streams
as the bf16 kernel does, its products in split TF32 (`cvt_f32_plan`).
Other dtypes raise.

K12 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:119
fused_bias_attention` (body `_attn_kernel` :62) and its backward `_fba_bwd`
(:280, body `_attn_bwd_kernel` :193): the same function on MViT's
token-concat layout (`MViTConfig.cls_stream=False`). q, k and v are (B*H,
L, D) with the cls token at row 0 of each; the bias terms are three f32
tensors rel_t (B*H, Lq, kt), rel_h (.., kh), rel_w (.., kw) whose row 0
the caller zeroes (the JAX einsum of bf16 q with the f32 tables promotes
them to f32); the residual adds q to rows >= 1 only. It is bound by
operations as K1 and K5 are. The kernels are K1's and K5's templates
instantiated for this layout (`csrc/attention.cu` entry
`dsal_cls_attention`, `csrc/attention_bwd.cu` entry
`dsal_cls_attention_bwd`): B*H batches of one head, the rel parts read
and their gradients written in f32 through per-part pointers, the cls row
inside the first query tile. `fused_bias_attention` is an autograd
Function whose forward is K12 and whose backward is K12's backward kernel
(plain versions on the CPU); gradients reach q, k, v and the three rel
tensors.

K7 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:893
cvt_cross_attention` (body `_cvt_attn_kernel` :841): the SalUNet
decoder's CvT cross-attention softmax(q k^T * scale) v per head, q (Bt, L,
C) with L up to 5376 and k, v (Bt, S, C) pooled to S = 18 keys, scale =
C^-1/2 (the reference's full-dim quirk). It runs at eval with
`SalUNetConfig.fused_attn`. With so few keys it is bound by the bytes of q
and out (4 S flops per q element), so the bf16 kernel
(`csrc/cvt_attention.cu`) streams: persistent CTAs walk 64-row tiles of
whole rows (all heads, as the TPU kernel's blocks), which a producer warp
brings by TMA into a ring of buffers and stores back by TMA once computed,
with k and v of the current batch item resident; four or eight consumer
warps take the scores on the tensor cores (bf16 mma.sync, f32 accumulation), the
softmax in f32 in registers, p rounded to bf16 for p v, one rounding of the
output. `cvt_plan` mirrors its geometry (keys padded to 16-128, head groups
where whole rows' k and v do not fit or the tiles are fewer than the SMs,
warps per tile, buffers, CTAs per SM). The (L, S)
scores never reach device memory. K7 is eval-only, in the JAX package and
here: `cvt_cross_attention` raises when grad mode is on and an input
requires grad.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "bias_attention", "attention.cu", "dsal_bias_attention",
    [K.P] * 6 + [K.I] * 8 + [K.F, K.I, K.I, K.I, K.P],
    replaces="diff_sal_tpu/ops/attention.py:601 fused_bias_attention_v2 "
             "(_attn_v2_kernel :477)",
)
BWD_KERNEL = K.Kernel(
    "bias_attention_bwd", "attention_bwd.cu", "dsal_bias_attention_bwd",
    [K.P] * 14 + [K.I] * 9 + [K.F, K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/attention.py:761 _fba2_bwd "
             "(_attn_v2_bwd_kernel :697)",
)

HEAD_DIMS = (64, 96, 128)
MAX_REL = 256
MAX_REL_BWD = 128
CVT_KERNEL = K.Kernel(
    "cvt_attention", "cvt_attention.cu", "dsal_cvt_attention",
    [K.P] * 4 + [K.I] * 5 + [K.F, K.P],
    replaces="diff_sal_tpu/ops/attention.py:893 cvt_cross_attention "
             "(_cvt_attn_kernel :841)",
)

CLS_KERNEL = K.Kernel(
    "fused_bias_attention", "attention.cu", "dsal_cls_attention",
    [K.P] * 8 + [K.I] * 7 + [K.F, K.I, K.I, K.I, K.P],
    replaces="diff_sal_tpu/ops/attention.py:119 fused_bias_attention "
             "(_attn_kernel :62)",
)
CLS_BWD_KERNEL = K.Kernel(
    "fused_bias_attention_bwd", "attention_bwd.cu", "dsal_cls_attention_bwd",
    [K.P] * 18 + [K.I] * 8 + [K.F, K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/attention.py:280 _fba_bwd "
             "(_attn_bwd_kernel :193)",
)

# the f32 instances (the forward in csrc/attention_f32_fwd.cu, the backward
# in csrc/attention_f32.cu, K7's in csrc/cvt_attention.cu): the same TPU
# kernels, which take f32 as they take bf16
F32_KERNEL = K.Kernel(
    "bias_attention_f32", "attention_f32_fwd.cu", "dsal_bias_attention_f32",
    [K.P] * 6 + [K.I] * 8 + [K.F, K.I, K.P], replaces=KERNEL.replaces)
F32_BWD_KERNEL = K.Kernel(
    "bias_attention_bwd_f32", "attention_f32.cu", "dsal_bias_attention_bwd_f32",
    [K.P] * 12 + [K.I] * 9 + [K.F, K.I, K.P], replaces=BWD_KERNEL.replaces)
CLS_F32_KERNEL = K.Kernel(
    "fused_bias_attention_f32", "attention_f32_fwd.cu", "dsal_cls_attention_f32",
    [K.P] * 8 + [K.I] * 7 + [K.F, K.I, K.P], replaces=CLS_KERNEL.replaces)
CLS_F32_BWD_KERNEL = K.Kernel(
    "fused_bias_attention_bwd_f32", "attention_f32.cu", "dsal_cls_attention_bwd_f32",
    [K.P] * 16 + [K.I] * 8 + [K.F, K.I, K.P], replaces=CLS_BWD_KERNEL.replaces)
CVT_F32_KERNEL = K.Kernel(
    "cvt_attention_f32", "cvt_attention.cu", "dsal_cvt_attention_f32",
    [K.P] * 4 + [K.I] * 5 + [K.F, K.P], replaces=CVT_KERNEL.replaces)
F32_KERNELS = (F32_KERNEL, F32_BWD_KERNEL, CLS_F32_KERNEL, CLS_F32_BWD_KERNEL, CVT_F32_KERNEL)

BWD_BLOCK = 64        # rows per CTA and keys per tile of K5 and K12's backward
BWD_TARGET_CTAS = 264  # two CTAs on each of 132 SMs for the k-major part of K5
BWD_STAGES = 2        # ring buffers of either backward kernel
BWD_THREADS = 128     # one warpgroup; its thread 0 issues the loads
F32_MAX_SPLITS = 8    # CTAs of a cluster that share one row tile's keys (f32 forward)
F32_BWD_BN = 32       # keys per tile of the f32 backward's q-major kernel
F32_BWD_BM = 32       # query rows per tile of its k-major kernel
F32_BWD_KROWS = 64    # keys per k-major CTA (four warps of 16)
F32_BWD_MAX_WAVES = 8  # of k-major CTAs, at most, that query splits make

SMEM_MAX = 232_448    # dynamic shared memory one CTA may use on the H100
SM_SMEM = 233_472     # shared memory of an SM; each CTA also holds 1 KB
NUM_SMS = 132


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """Geometry of one K1 / K12 forward launch.

    `rows` query rows per CTA (64: one consumer warpgroup, 128: two),
    `block_n` keys per tile, `stages` K/V buffers in the TMA ring, `smem`
    dynamic shared-memory bytes, `q_tiles` CTAs per (batch, head), `ctas`
    the grid, and `tma` the tensor maps the C entry builds, as (name,
    dims, byte strides of dims 1 and 2, box), innermost first."""

    rows: int
    block_n: int
    stages: int
    smem: int
    q_tiles: int
    ctas: int
    tma: Tuple[Tuple[str, Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]], ...]


def fwd_smem(D: int, rows: int, block_n: int, stages: int, Lk: int,
             k_shape: Tuple[int, int, int]) -> int:
    """Dynamic shared memory of one forward CTA, as `smem_layout` in
    csrc/attention.cu lays it out: Q, the K and V rings, the per-row bias
    table ((t, h) sums, rel_w, two zeros and a -inf entry, the raw rel_t
    and rel_h; rows padded to 4 mod 32 floats), the key-column table, the
    mbarriers and 1024 bytes to align the base."""
    kt, kh, kw = k_shape
    ntiles = -(-Lk // block_n)
    rs = (kt * kh + kw + 3 + kt + kh + 27) // 32 * 32 + 4
    return (rows * D * 2 + 2 * stages * block_n * D * 2 + rows * rs * 4
            + ntiles * block_n * 4 + (4 * stages + 1) * 8 + 1024)


@functools.lru_cache(maxsize=None)  # the wrappers ask once per call, with few distinct shapes
def fwd_plan(B: int, H: int, Lq: int, Lk: int, D: int,
             k_shape: Tuple[int, int, int]) -> FwdPlan:
    """Choose the forward kernel's geometry for B batches of H heads
    (K12: B*heads batches of one head). 128 rows per CTA (two consumer
    warpgroups share each K/V tile) unless that leaves fewer CTAs than the
    card has SMs, then 64; as many ring stages as fit, up to four.
    Raises ValueError on a head_dim or key grid the kernel does not take."""
    kt, kh, kw = k_shape
    if D not in HEAD_DIMS:
        raise ValueError(f"bias attention forward: head_dim {D} not in {HEAD_DIMS}")
    if kt + kh + kw > MAX_REL:
        raise ValueError(f"bias attention forward: kt+kh+kw = {kt + kh + kw} > {MAX_REL}")
    if Lq < 1 or Lk < 1:
        raise ValueError(f"bias attention forward: Lq {Lq}, Lk {Lk}")
    first = 128 if B * H * -(-Lq // 128) >= NUM_SMS else 64
    for rows in ((128, 64) if first == 128 else (64,)):
        # two consumer warpgroups: 64-key tiles in a deeper ring; one: 128-key
        # tiles (measured on the H100 at MViT's block shapes, PERF.md), as
        # `dispatch` in csrc/attention.cu derives them
        bn = 64 if rows == 128 else 128
        for stages in ((4, 3, 2) if rows == 128 else (2,)):
            smem = fwd_smem(D, rows, bn, stages, Lk, k_shape)
            if smem <= SMEM_MAX:
                HD = H * D
                tma = tuple((name, (HD, L, B), (HD * 2, L * HD * 2), (32, box, 1))
                            for name, L, box in (("q", Lq, rows), ("k", Lk, bn), ("v", Lk, bn)))
                q_tiles = -(-Lq // rows)
                return FwdPlan(rows, bn, stages, smem, q_tiles, B * H * q_tiles, tma)
    raise ValueError(f"bias attention forward: key grid {k_shape} at head_dim {D} needs more "
                     f"than {SMEM_MAX} bytes of shared memory")


@dataclasses.dataclass(frozen=True)
class F32FwdPlan:
    """Geometry of one f32 forward launch (K1 / K12 in f32,
    `csrc/attention_f32_fwd.cu`, which chooses it itself): `rows` query
    rows per CTA (16 per warp: 8 warps or 4), `block_n` keys per tile of
    the double buffer, `ntiles` key tiles, `q_tiles` row tiles per (batch,
    head), `splits` CTAs of a cluster that share a row tile's key tiles
    (1: no split), `ctas` the grid, `smem` dynamic shared-memory bytes."""

    rows: int
    block_n: int
    threads: int
    ntiles: int
    q_tiles: int
    splits: int
    ctas: int
    smem: int


def f32_fwd_smem(D: int, rows: int, block_n: int, Lk: int, K: int) -> int:
    """Dynamic shared memory of one f32 forward CTA, as `smem_layout` in
    csrc/attention_f32_fwd.cu lays it out: Q (rows x D + 8 floats), the K
    and V double buffers (block_n x D + 8, block_n x D + 4), the key table
    (one int per key of every tile) and the bias rows (rows x K + 2)."""
    ntiles = -(-Lk // block_n)
    return 4 * (rows * (D + 8) + 2 * block_n * (D + 8) + 2 * block_n * (D + 4)
                + ntiles * block_n + rows * (K + 2))


@functools.lru_cache(maxsize=None)  # the wrappers ask once per call, with few distinct shapes
def f32_fwd_plan(B: int, H: int, Lq: int, Lk: int, D: int,
                 k_shape: Tuple[int, int, int]) -> F32FwdPlan:
    """The f32 forward's geometry for B batches of H heads (K12: B*heads
    batches of one head), as `run` in csrc/attention_f32_fwd.cu chooses it:
    128 rows per CTA where that still gives every SM a CTA, else 64;
    64-key tiles, unless 32-key tiles let two CTAs share an SM where 64 do
    not and the grid holds more CTAs than SMs, or 64 do not fit in shared
    memory; where the row tiles are fewer than the SMs, the keys split over
    a cluster of up to `F32_MAX_SPLITS` CTAs (32-key tiles where two CTAs
    then share an SM), at most two CTAs per SM in all. Raises ValueError on a
    head_dim, key grid or size the kernel does not take."""
    K = sum(k_shape)
    if D not in HEAD_DIMS:
        raise ValueError(f"f32 attention forward: head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= K <= MAX_REL_BWD:
        raise ValueError(f"f32 attention forward: kt+kh+kw = {K} not in 1..{MAX_REL_BWD}")
    if Lq < 1 or Lk < 1:
        raise ValueError(f"f32 attention forward: Lq {Lq}, Lk {Lk}")
    first = 128 if B * H * -(-Lq // 128) >= NUM_SMS else 64
    for rows in ((128, 64) if first == 128 else (64,)):
        ctas = B * H * -(-Lq // rows)
        s64, s32 = (f32_fwd_smem(D, rows, bn, Lk, K) for bn in (64, 32))
        bn = 64 if s64 <= SMEM_MAX else 0
        if s32 <= SMEM_MAX and (not bn or (ctas > NUM_SMS and 2 * (s32 + 1024) <= SM_SMEM
                                           and 2 * (s64 + 1024) > SM_SMEM)):
            bn = 32
        if not bn:
            continue
        splits = 1
        if ctas < NUM_SMS and Lk > 32 and s32 <= SMEM_MAX:
            if 2 * (s32 + 1024) <= SM_SMEM:
                bn = 32
            nt = -(-Lk // bn)
            split = min(2 * NUM_SMS // ctas, F32_MAX_SPLITS, nt)
            per = -(-nt // split)
            splits = -(-nt // per)
        q_tiles = -(-Lq // rows)
        return F32FwdPlan(rows, bn, 2 * rows, -(-Lk // bn), q_tiles, splits,
                          B * H * q_tiles * splits, s64 if bn == 64 else s32)
    raise ValueError(f"f32 attention forward: Lk {Lk}, kt+kh+kw = {K} at head_dim {D} need more "
                     f"than {SMEM_MAX} bytes of shared memory")


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Geometry of one K5 / K12 backward launch (`csrc/attention_bwd.cu`).

    Both kernels run `threads` threads per CTA (one warpgroup of `rows`
    rows) with `stages` ring buffers. The q-major kernel: `q_ctas` CTAs of 64 query rows walking `ntiles` key tiles of
    `block_n` twice, `smem_q` bytes; its dRel product has N = `bins`. The
    k-major kernel: `k_ctas` CTAs of 64 keys, each over one of `splits`
    query splits, `smem_k` bytes. Workspaces: `relp_cols` floats per query
    row (raw rel terms, 0, -inf, lse, delta), the key tables (`ntiles` E
    tiles of 64 x `bins` bf16 and 64 key indices) and the split partials."""

    rows: int
    block_n: int
    stages: int
    threads: int
    bins: int
    relp_cols: int
    ntiles: int
    splits: int
    q_ctas: int
    k_ctas: int
    smem_q: int
    smem_k: int


def _bwd_bins(K: int) -> int:
    """The bias bins padded to the N of the dRel product (`pad_bins`)."""
    return 32 if K <= 32 else (48 if K <= 48 else 128)


def _relp_cols(K: int) -> int:
    """Floats per relp row: K raw terms, 0, -inf, lse, delta, padded to 16
    bytes (`relp_cols`)."""
    return -(-(K + 4) // 4) * 4


def bwd_smem(D: int, K: int) -> Tuple[int, int]:
    """Dynamic shared memory of the q-major and the k-major backward CTA,
    as `q_layout` and `k_layout` in csrc/attention_bwd.cu lay them out."""
    tile = BWD_BLOCK * D * 2
    st = BWD_STAGES
    q = (2 * tile + 2 * st * tile + st * BWD_BLOCK * _bwd_bins(K) * 2 + st * BWD_BLOCK * 4
         + BWD_BLOCK * ((K + 4) | 1) * 4)
    q = -(-q // 8) * 8 + (st + 1) * 8 + 1024
    k = 3 * tile + 2 * st * tile + st * BWD_BLOCK * _relp_cols(K) * 4 + (st + 1) * 8 + 1024
    return q, k


@functools.lru_cache(maxsize=None)  # the wrappers ask once per call, with few distinct shapes
def bwd_plan(B: int, H: int, Lq: int, Lk: int, D: int,
             k_shape: Tuple[int, int, int]) -> BwdPlan:
    """The backward's geometry for B batches of H heads (K12: B*heads
    batches of one head). Raises ValueError on a head_dim, key grid or
    shared-memory need the kernels do not take."""
    K = sum(k_shape)
    if D not in HEAD_DIMS:
        raise ValueError(f"bias attention backward: head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= K <= MAX_REL_BWD:
        raise ValueError(f"bias attention backward: kt+kh+kw = {K} not in 1..{MAX_REL_BWD}")
    if Lq < 1 or Lk < 1:
        raise ValueError(f"bias attention backward: Lq {Lq}, Lk {Lk}")
    smem_q, smem_k = bwd_smem(D, K)
    if max(smem_q, smem_k) > SMEM_MAX:
        raise ValueError(f"bias attention backward: head_dim {D}, kt+kh+kw = {K} need more "
                         f"than {SMEM_MAX} bytes of shared memory")
    ntiles = -(-Lk // BWD_BLOCK)
    splits = bwd_splits(B, H, Lq, Lk)
    return BwdPlan(BWD_BLOCK, BWD_BLOCK, BWD_STAGES, BWD_THREADS, _bwd_bins(K), _relp_cols(K),
                   ntiles, splits, B * H * -(-Lq // BWD_BLOCK), B * H * ntiles * splits, smem_q,
                   smem_k)


@dataclasses.dataclass(frozen=True)
class F32BwdPlan:
    """Geometry of one f32 backward (K5 / K12 backward in f32,
    `csrc/attention_f32.cu`, which chooses it itself): the q-major kernel's
    `q_rows` query rows per CTA (16 per warp), `q_ctas` CTAs, `key_tiles`
    tiles of `block_n` keys (walked twice) and `smem_q` bytes; the drel
    product's N, `bins` (kt + kh + kw padded to 32, 48 or 128); the k-major
    kernel's `k_ctas` CTAs of `k_rows` keys, each over one of `splits`
    query splits of `q_tiles` tiles of `block_m` rows (`per_split` tiles
    each, none empty), `smem_k` bytes."""

    q_rows: int
    q_ctas: int
    block_n: int
    key_tiles: int
    bins: int
    smem_q: int
    k_rows: int
    block_m: int
    q_tiles: int
    splits: int
    per_split: int
    k_ctas: int
    smem_k: int


def f32_bwd_smem(D: int, q_rows: int, K: int) -> Tuple[int, int]:
    """Dynamic shared memory of the f32 backward's q-major and k-major CTA,
    as `q_smem` and `k_smem` in csrc/attention_f32.cu: q-major, Q and G
    (q_rows x D + 4 floats), the K and V double buffers (32 x D + 4 each),
    two 32-key tables and the bias rows (q_rows x K + 2); k-major, K and V
    (64 x D + 4), the Q and G double buffers (32 x D + 4 each), and per
    buffer the bias rows (32 x K + 2), lse and delta."""
    bn, bm, kr, sd = F32_BWD_BN, F32_BWD_BM, F32_BWD_KROWS, D + 4
    return (4 * (2 * q_rows * sd + 4 * bn * sd + 2 * bn + q_rows * (K + 2)),
            4 * (2 * kr * sd + 4 * bm * sd + 2 * bm * (K + 2) + 4 * bm))


def _f32_bwd_splits(ctas: int, q_tiles: int, per_sm: int) -> int:
    """The k-major kernel's query splits (`plan_splits` in
    csrc/attention_f32.cu): of the counts that leave no split empty and
    make at most `F32_BWD_MAX_WAVES` waves, the one with the fewest query
    tiles per CTA times waves of `ctas` x splits CTAs over `per_sm` x 132
    slots, the fewest splits on a tie."""
    slots = per_sm * NUM_SMS
    best = None
    for s in range(1, min(q_tiles, max(1, F32_BWD_MAX_WAVES * slots // ctas)) + 1):
        per = -(-q_tiles // s)
        if -(-q_tiles // per) != s:
            continue
        cost = -(-ctas * s // slots) * per
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


@functools.lru_cache(maxsize=None)  # the wrappers ask once per call, with few distinct shapes
def f32_bwd_plan(B: int, H: int, Lq: int, Lk: int, D: int,
                 k_shape: Tuple[int, int, int]) -> F32BwdPlan:
    """The f32 backward's geometry for B batches of H heads (K12: B*heads
    batches of one head), as csrc/attention_f32.cu chooses it: 64 query rows
    per q-major CTA where that gives every SM a CTA, else 32, else 16; query
    splits of the k-major kernel by `_f32_bwd_splits`. Raises ValueError on
    a head_dim or key grid the kernels do not take."""
    K = sum(k_shape)
    if D not in HEAD_DIMS:
        raise ValueError(f"f32 attention backward: head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= K <= MAX_REL_BWD:
        raise ValueError(f"f32 attention backward: kt+kh+kw = {K} not in 1..{MAX_REL_BWD}")
    if Lq < 1 or Lk < 1:
        raise ValueError(f"f32 attention backward: Lq {Lq}, Lk {Lk}")
    BH = B * H
    rows = 64 if BH * -(-Lq // 64) >= NUM_SMS else (32 if BH * -(-Lq // 32) >= NUM_SMS else 16)
    smem_q, smem_k = f32_bwd_smem(D, rows, K)
    # at most 168,704 bytes (head_dim 128, 128 bins): every shape fits
    assert max(smem_q, smem_k) <= SMEM_MAX
    ktiles = -(-Lk // F32_BWD_KROWS)
    q_tiles = -(-Lq // F32_BWD_BM)
    splits = _f32_bwd_splits(BH * ktiles, q_tiles, 2 if 2 * (smem_k + 1024) <= SM_SMEM else 1)
    per = -(-q_tiles // splits)
    return F32BwdPlan(rows, BH * -(-Lq // rows), F32_BWD_BN, -(-Lk // F32_BWD_BN), _bwd_bins(K),
                      smem_q, F32_BWD_KROWS, F32_BWD_BM, q_tiles, splits, per,
                      BH * ktiles * splits, smem_k)


def _shapes(q, k, rel, k_shape, num_heads):
    B, Lq, HD = q.shape
    H = num_heads
    D = HD // H
    kt, kh, kw = k_shape
    if H * D != HD or k.shape[1] != 1 + kt * kh * kw:
        raise ValueError(f"bias_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"heads {H}, k_shape {k_shape}")
    if tuple(rel.shape) != (B, Lq, H, kt + kh + kw):
        raise ValueError(f"bias_attention: rel {tuple(rel.shape)} != "
                         f"{(B, Lq, H, kt + kh + kw)}")
    return B, Lq, H, D, k.shape[1]


def _logits(q, k, rel, k_shape, H, scale):
    """The biased scores (B, H, Lq, Lk) in the accumulation dtype, q*scale
    rounded in q's dtype first."""
    B, Lq, _, D, Lk = _shapes(q, k, rel, k_shape, H)
    kt, kh, kw = k_shape
    f = K.acc_dtype(q.dtype)
    qs = q.reshape(B, Lq, H, D) * torch.tensor(scale, dtype=q.dtype)
    scores = torch.einsum("blhd,bkhd->bhlk", qs.to(f), k.reshape(B, Lk, H, D).to(f))
    r = rel.to(f)
    bias = (r[..., :kt, None, None] + r[..., None, kt:kt + kh, None]
            + r[..., None, None, kt + kh:]).reshape(B, Lq, H, kt * kh * kw)
    bias = torch.nn.functional.pad(bias, (1, 0))  # zero bias for the cls key
    return scores + bias.permute(0, 2, 1, 3)


def _probs(q, k, rel, k_shape, H, scale):
    """Softmax probabilities (B, H, Lq, Lk) of the biased scores in the
    accumulation dtype."""
    return torch.softmax(_logits(q, k, rel, k_shape, H, scale), dim=-1)


def bias_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel: torch.Tensor, k_shape: Tuple[int, int, int],
                         num_heads: int, scale: float,
                         residual: bool = True, return_lse: bool = False):
    """K1's plain version: materialized f32 scores, the bias broadcast from
    rel, softmax, probabilities rounded to the input dtype before the
    product with v, f32 accumulation, residual added before the final
    rounding. With `return_lse`, also each row's logsumexp of the biased
    scores, (B, H, Lq) in the accumulation dtype, as the kernel saves it
    for the backward."""
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    f = K.acc_dtype(q.dtype)
    logits = _logits(q, k, rel, k_shape, H, scale)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhlk,bkhd->blhd", probs.to(q.dtype).to(f),
                       v.reshape(B, Lk, H, D).to(f)).reshape(B, Lq, H * D)
    if residual:
        out = out + q.to(f)
    out = out.to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def bias_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel: torch.Tensor, g: torch.Tensor,
                             k_shape: Tuple[int, int, int], num_heads: int,
                             scale: float, residual: bool = True, lse=None):
    """K5's plain version: (dq, dk, dv, drel) of K1 for the output gradient
    g, rounding where the TPU kernel rounds: probabilities recomputed in
    f32, p rounded to q's dtype for dv, ds = p * (dp - rowsum(dp * p)) in
    f32 and rounded for dq and dk, f32 accumulation, dq scaled by `scale`
    (plus g when `residual`), drel = ds summed over the keys sharing each
    t, h and w (the cls key left out) in f32; every output in its input's
    dtype. `lse`, the forward's logsumexp that the kernel reads, is not
    needed here: the softmax is recomputed whole."""
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    kt, kh, kw = k_shape
    dt, f = q.dtype, K.acc_dtype(q.dtype)
    p = _probs(q, k, rel, k_shape, H, scale)
    g4 = g.reshape(B, Lq, H, D).to(f)
    k4 = k.reshape(B, Lk, H, D).to(f)
    dv = torch.einsum("bhlk,blhd->bkhd", p.to(dt).to(f), g4)
    dp = torch.einsum("blhd,bkhd->bhlk", g4, v.reshape(B, Lk, H, D).to(f))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_lo = ds.to(dt).to(f)
    dq = torch.einsum("bhlk,bkhd->blhd", ds_lo, k4) * scale
    if residual:
        dq = dq + g4
    dk = torch.einsum("bhlk,blhd->bkhd", ds_lo, q.reshape(B, Lq, H, D).to(f)) * scale
    d5 = ds[..., 1:].reshape(B, H, Lq, kt, kh, kw)
    drel = torch.cat([d5.sum((4, 5)), d5.sum((3, 5)), d5.sum((3, 4))], dim=-1)
    return (dq.reshape(B, Lq, H * D).to(dt), dk.reshape(B, Lk, H * D).to(k.dtype),
            dv.reshape(B, Lk, H * D).to(v.dtype), drel.permute(0, 2, 1, 3).to(rel.dtype))


def _check_tensors(name, device, items):
    """Each (what, tensor, dtype) has that dtype and is contiguous, 16-byte
    aligned and on `device`. The messages are built only on failure: the
    wrappers check on every launch, and on the host-bound paths that time
    counts."""
    for what, t, want in items:
        if t.dtype != want:
            raise ValueError(f"{name}: {what} must be {want}, got {t.dtype}")
        if not (t.device == device and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name}: {what} must be contiguous, 16-byte aligned, on {device}")


def _check_common(name, q, k, v, D, k_shape, max_rel):
    if v.shape != k.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: v {tuple(v.shape)}, k {tuple(k.shape)}, q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if sum(k_shape) > max_rel:
        raise ValueError(f"{name}: kt+kh+kw > {max_rel}")


@functools.lru_cache(maxsize=None)
def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """The scale as the kernels apply it: rounded in the inputs' dtype, as the
    TPU kernel computes q * scale."""
    return float(torch.tensor(scale, dtype=dtype))


CARD_DTYPES = (torch.bfloat16, torch.float32)  # the instances the card has


def _card_dtype(name, q):
    """q's dtype, if a kernel instance takes it (bf16: the Hopper kernels;
    f32: the f32 instances), else ValueError."""
    if q.dtype not in CARD_DTYPES:
        raise ValueError(f"{name}: q must be bfloat16 or float32 on the card, got {q.dtype}")
    return q.dtype


def _check_cuda_inputs(name, q, k, v, rel, k_shape, num_heads, max_rel, extra=()):
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    dt = _card_dtype(name, q)
    _check_tensors(name, q.device, [(what, t, dt) for what, t in
                                    (("q", q), ("k", k), ("v", v), ("rel", rel)) + tuple(extra)])
    _check_common(name, q, k, v, D, k_shape, max_rel)
    return B, Lq, H, D, Lk


def bias_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rel: torch.Tensor, k_shape: Tuple[int, int, int],
                       num_heads: int, scale: float,
                       residual: bool = True, return_lse: bool = False):
    """Kernel K1 on CUDA (bf16, or its f32 instance for f32), the plain
    version on the CPU; no autograd. With `return_lse`, (out, lse): each
    row's logsumexp (B, H, Lq), f32 from the kernel."""
    K.refuse_dtensor("bias_attention", q, k, v, rel)
    if q.device.type == "cpu":
        return bias_attention_plain(q, k, v, rel, k_shape, num_heads, scale, residual,
                                    return_lse)
    K.require_cuda(q, "bias_attention")
    B, Lq, H, D, Lk = _check_cuda_inputs("bias_attention", q, k, v, rel, k_shape,
                                         num_heads, MAX_REL)
    kt, kh, kw = k_shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if return_lse else None
    scale_q = _rounded_scale(float(scale), q.dtype)
    if q.dtype == torch.float32:
        f32_fwd_plan(B, H, Lq, Lk, D, tuple(k_shape))  # raises on what the kernel refuses
        F32_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(), lse_ptr,
            B, Lq, Lk, H, D, kt, kh, kw, scale_q, int(residual), K.stream(),
        )
    else:
        plan = fwd_plan(B, H, Lq, Lk, D, tuple(k_shape))
        KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(), lse_ptr,
            B, Lq, Lk, H, D, kt, kh, kw, scale_q, int(residual), plan.rows, plan.stages,
            K.stream(),
        )
    return (out, lse) if return_lse else out


def bwd_splits(B: int, H: int, Lq: int, Lk: int) -> int:
    """Number of query splits of the backward's k-major part (64 keys and
    query rows per tile): enough CTAs for two on each SM, at most one query
    tile per split."""
    ctas = B * H * -(-Lk // BWD_BLOCK)
    return max(1, min(-(-BWD_TARGET_CTAS // ctas), -(-Lq // BWD_BLOCK)))


def _bwd_workspaces(q, k, B, H, Lq, Lk, D, k_shape):
    """(splits, scratch) of the backward kernels, allocated here (the
    kernels allocate nothing): for bf16 the relp rows, the key tables (E
    tiles, key indices) and the split partials; for the f32 instances
    delta and the split partials."""
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:  # the split partials only where the queries are split
        splits = f32_bwd_plan(B, H, Lq, Lk, D, tuple(k_shape)).splits
        return splits, (torch.empty((B, H, Lq), **f32),
                        torch.empty((2, splits) + tuple(k.shape) if splits > 1 else (1,), **f32))
    plan = bwd_plan(B, H, Lq, Lk, D, tuple(k_shape))
    return plan.splits, (
        torch.empty((B * H, Lq, plan.relp_cols), **f32),
        torch.empty(plan.ntiles * plan.block_n * plan.bins * 2, dtype=torch.uint8,
                    device=q.device),
        torch.empty(plan.ntiles * plan.block_n, dtype=torch.int32, device=q.device),
        torch.empty((2, plan.splits) + tuple(k.shape), **f32))


def _check_lse(name, lse, shape, device):
    if lse is None:
        raise ValueError(f"{name}: the kernel reads the forward's logsumexp; pass lse=")
    _check_tensors(name, device, [("lse", lse, torch.float32)])
    K.check(tuple(lse.shape) == shape, f"{name}: lse {tuple(lse.shape)} != {shape}")


def bias_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rel: torch.Tensor, g: torch.Tensor,
                       k_shape: Tuple[int, int, int], num_heads: int,
                       scale: float, residual: bool = True, lse=None):
    """(dq, dk, dv, drel) of K1: kernel K5 on CUDA (bf16, or its f32
    instance for f32; `lse` the forward's (B, H, Lq) logsumexp), the plain
    version on the CPU."""
    K.refuse_dtensor("bias_attention_bwd", q, k, v, rel, g, lse)
    if q.device.type == "cpu":
        return bias_attention_bwd_plain(q, k, v, rel, g, k_shape, num_heads, scale, residual)
    K.require_cuda(q, "bias_attention_bwd")
    B, Lq, H, D, Lk = _check_cuda_inputs("bias_attention_bwd", q, k, v, rel, k_shape,
                                         num_heads, MAX_REL_BWD, (("g", g),))
    K.check(tuple(g.shape) == tuple(q.shape), "bias_attention_bwd: g shape != q shape")
    _check_lse("bias_attention_bwd", lse, (B, H, Lq), q.device)
    kt, kh, kw = k_shape
    dq, drel = torch.empty_like(q), torch.empty_like(rel)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    splits, ws = _bwd_workspaces(q, k, B, H, Lq, Lk, D, k_shape)
    scale_q = _rounded_scale(float(scale), q.dtype)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drel.data_ptr(),
            *(w.data_ptr() for w in ws))
    sizes = (B, Lq, Lk, H, D, kt, kh, kw, splits)
    if q.dtype == torch.float32:
        F32_BWD_KERNEL.launch(*ptrs, *sizes, scale_q, int(residual), K.stream())
    else:
        BWD_KERNEL.launch(*ptrs, *sizes, scale_q, float(scale), int(residual), K.stream())
    return dq, dk, dv, drel


class _BiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel, k_shape, num_heads, scale, residual):
        ctx.args = (k_shape, num_heads, scale, residual)
        if not any(ctx.needs_input_grad[:4]):
            return bias_attention_fwd(q, k, v, rel, k_shape, num_heads, scale, residual)
        out, lse = bias_attention_fwd(q, k, v, rel, k_shape, num_heads, scale, residual,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, rel, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel, lse = ctx.saved_tensors
        grads = bias_attention_bwd(q, k, v, rel, g.contiguous(), *ctx.args, lse=lse)
        return grads + (None, None, None, None)


def bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rel: torch.Tensor, k_shape: Tuple[int, int, int],
                   num_heads: int, scale: float,
                   residual: bool = True) -> torch.Tensor:
    """K1 forward, K5 backward (plain versions on the CPU): the autograd
    Function records its backward whenever an input requires grad."""
    return _BiasAttention.apply(q, k, v, rel, tuple(k_shape), num_heads, scale, residual)


def _cls_shapes(q, k, rels, k_shape):
    BH, Lq, D = q.shape
    kt, kh, kw = k_shape
    if k.shape[0] != BH or k.shape[1] != 1 + kt * kh * kw or k.shape[2] != D:
        raise ValueError(f"fused_bias_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"k_shape {k_shape}")
    for r, n in zip(rels, k_shape):
        if tuple(r.shape) != (BH, Lq, n):
            raise ValueError(f"fused_bias_attention: rel {tuple(r.shape)} != {(BH, Lq, n)}")
    return BH, Lq, D, k.shape[1]


def _cls_logits(q, k, rels, k_shape, scale):
    """K12's biased scores (BH, Lq, Lk) in the accumulation dtype: q*scale
    rounded in q's dtype, the bias terms summed in f32 (t + h, then + w, as
    the TPU body's three products add), zero bias for key 0."""
    BH, Lq, _, _ = _cls_shapes(q, k, rels, k_shape)
    f = K.acc_dtype(q.dtype)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    scores = torch.einsum("bld,bkd->blk", qs.to(f), k.to(f))
    rt, rh, rw = (r.to(f) for r in rels)
    bias = (rt[..., :, None, None] + rh[..., None, :, None]
            + rw[..., None, None, :]).reshape(BH, Lq, -1)
    return scores + torch.nn.functional.pad(bias, (1, 0))


def _cls_probs(q, k, rels, k_shape, scale):
    """K12's softmax probabilities (BH, Lq, Lk) in the accumulation dtype."""
    return torch.softmax(_cls_logits(q, k, rels, k_shape, scale), dim=-1)


def fused_bias_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                               k_shape: Tuple[int, int, int], scale: float,
                               residual: bool = False, return_lse: bool = False):
    """K12's plain version, rounding where the TPU body rounds: q*scale in
    q's dtype, f32 scores and bias, the softmax normalised in f32 and
    rounded to q's dtype before the product with v (f32 accumulation),
    q added to rows >= 1 in f32 when `residual`, one rounding to q's
    dtype. With `return_lse`, also each row's logsumexp (BH, Lq)."""
    f = K.acc_dtype(q.dtype)
    logits = _cls_logits(q, k, (rel_t, rel_h, rel_w), k_shape, scale)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("blk,bkd->bld", p.to(q.dtype).to(f), v.to(f))
    if residual:
        out = torch.cat([out[:, :1], out[:, 1:] + q[:, 1:].to(f)], 1)
    out = out.to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def fused_bias_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   rel_t: torch.Tensor, rel_h: torch.Tensor,
                                   rel_w: torch.Tensor, g: torch.Tensor,
                                   k_shape: Tuple[int, int, int], scale: float,
                                   residual: bool = False, lse=None):
    """K12's backward, plain (JAX `_attn_bwd_kernel`, attention.py:193):
    p recomputed in f32, dv = p_lo^T g, dp = g v^T, ds = p * (dp -
    rowsum(dp * p)) in f32, dq = (ds_lo k) * scale (+ g on rows >= 1 when
    `residual`), dk = (ds_lo^T q) * scale with p_lo and ds_lo rounded to
    q's dtype and f32 accumulation; drel_t/h/w the unrounded ds summed over
    the keys sharing each t, h and w (key 0 left out). Returns (dq, dk,
    dv, drel_t, drel_h, drel_w), each in its input's dtype. `lse`, the
    forward's logsumexp that the kernel reads, is not needed here."""
    kt, kh, kw = k_shape
    dt, f = q.dtype, K.acc_dtype(q.dtype)
    rels = (rel_t, rel_h, rel_w)
    p = _cls_probs(q, k, rels, k_shape, scale)
    gf = g.to(f)
    dv = torch.einsum("blk,bld->bkd", p.to(dt).to(f), gf)
    dp = torch.einsum("bld,bkd->blk", gf, v.to(f))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_lo = ds.to(dt).to(f)
    dq = torch.einsum("blk,bkd->bld", ds_lo, k.to(f)) * scale
    if residual:
        dq = torch.cat([dq[:, :1], dq[:, 1:] + gf[:, 1:]], 1)
    dk = torch.einsum("blk,bld->bkd", ds_lo, q.to(f)) * scale
    d5 = ds[..., 1:].reshape(ds.shape[0], ds.shape[1], kt, kh, kw)
    drels = (d5.sum((3, 4)), d5.sum((2, 4)), d5.sum((2, 3)))
    return (dq.to(dt), dk.to(k.dtype), dv.to(v.dtype),
            *(d.to(r.dtype) for d, r in zip(drels, rels)))


def _check_cls_cuda_inputs(name, q, k, v, rels, k_shape, max_rel, extra=()):
    BH, Lq, D, Lk = _cls_shapes(q, k, rels, k_shape)
    dt = _card_dtype(name, q)
    qkv = [(what, t, dt) for what, t in (("q", q), ("k", k), ("v", v)) + extra]
    f32 = [(what, t, torch.float32) for what, t in zip(("rel_t", "rel_h", "rel_w"), rels)]
    _check_tensors(name, q.device, qkv + f32)
    _check_common(name, q, k, v, D, k_shape, max_rel)
    return BH, Lq, D, Lk


def fused_bias_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                             k_shape: Tuple[int, int, int], scale: float,
                             residual: bool = False, return_lse: bool = False):
    """Kernel K12 on CUDA (q, k, v bf16, or f32 for its f32 instance; rel
    f32), the plain version on the CPU; no autograd. With `return_lse`,
    (out, lse): each row's logsumexp (BH, Lq), f32 from the kernel."""
    K.refuse_dtensor("fused_bias_attention", q, k, v, rel_t, rel_h, rel_w)
    if q.device.type == "cpu":
        return fused_bias_attention_plain(q, k, v, rel_t, rel_h, rel_w, k_shape, scale,
                                          residual, return_lse)
    K.require_cuda(q, "fused_bias_attention")
    BH, Lq, D, Lk = _check_cls_cuda_inputs("fused_bias_attention", q, k, v,
                                           (rel_t, rel_h, rel_w), k_shape, MAX_REL)
    kt, kh, kw = k_shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, Lq), dtype=torch.float32, device=q.device) if return_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_t.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None)
    scale_q = _rounded_scale(float(scale), q.dtype)
    if q.dtype == torch.float32:
        f32_fwd_plan(BH, 1, Lq, Lk, D, tuple(k_shape))  # raises on what the kernel refuses
        CLS_F32_KERNEL.launch(*ptrs, BH, Lq, Lk, D, kt, kh, kw, scale_q, int(residual),
                              K.stream())
    else:
        plan = fwd_plan(BH, 1, Lq, Lk, D, tuple(k_shape))
        CLS_KERNEL.launch(*ptrs, BH, Lq, Lk, D, kt, kh, kw, scale_q, int(residual), plan.rows,
                          plan.stages, K.stream())
    return (out, lse) if return_lse else out


def fused_bias_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                             g: torch.Tensor, k_shape: Tuple[int, int, int], scale: float,
                             residual: bool = False, lse=None):
    """(dq, dk, dv, drel_t, drel_h, drel_w) of K12: its backward kernel on
    CUDA (q, k, v, g bf16, or f32 for the f32 instance; f32 rel and d-rel;
    `lse` the forward's (BH, Lq) logsumexp), the plain version on the
    CPU."""
    K.refuse_dtensor("fused_bias_attention_bwd", q, k, v, rel_t, rel_h, rel_w, g, lse)
    if q.device.type == "cpu":
        return fused_bias_attention_bwd_plain(q, k, v, rel_t, rel_h, rel_w, g, k_shape, scale,
                                              residual)
    K.require_cuda(q, "fused_bias_attention_bwd")
    rels = (rel_t, rel_h, rel_w)
    BH, Lq, D, Lk = _check_cls_cuda_inputs("fused_bias_attention_bwd", q, k, v, rels, k_shape,
                                           MAX_REL_BWD, (("g", g),))
    K.check(tuple(g.shape) == tuple(q.shape), "fused_bias_attention_bwd: g shape != q shape")
    _check_lse("fused_bias_attention_bwd", lse, (BH, Lq), q.device)
    kt, kh, kw = k_shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drels = [torch.empty_like(r) for r in rels]
    splits, ws = _bwd_workspaces(q, k, BH, 1, Lq, Lk, D, k_shape)
    scale_q = _rounded_scale(float(scale), q.dtype)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *(r.data_ptr() for r in rels),
            g.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(d.data_ptr() for d in drels), *(w.data_ptr() for w in ws))
    sizes = (BH, Lq, Lk, D, kt, kh, kw, splits)
    if q.dtype == torch.float32:
        CLS_F32_BWD_KERNEL.launch(*ptrs, *sizes, scale_q, int(residual), K.stream())
    else:
        CLS_BWD_KERNEL.launch(*ptrs, *sizes, scale_q, float(scale), int(residual), K.stream())
    return (dq, dk, dv, *drels)


class _FusedBiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_t, rel_h, rel_w, k_shape, scale, residual):
        ctx.args = (k_shape, scale, residual)
        if not any(ctx.needs_input_grad[:6]):
            return fused_bias_attention_fwd(q, k, v, rel_t, rel_h, rel_w, k_shape, scale,
                                            residual)
        out, lse = fused_bias_attention_fwd(q, k, v, rel_t, rel_h, rel_w, k_shape, scale,
                                            residual, return_lse=True)
        ctx.save_for_backward(q, k, v, rel_t, rel_h, rel_w, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        *ins, lse = ctx.saved_tensors
        grads = fused_bias_attention_bwd(*ins, g.contiguous(), *ctx.args, lse=lse)
        return grads + (None, None, None)


def fused_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                         k_shape: Tuple[int, int, int], scale: float,
                         residual: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v (+ q on rows >= 1) for MViT's
    token-concat layout: K12 forward, K12's backward kernel for the
    gradients (plain versions on the CPU)."""
    return _FusedBiasAttention.apply(q, k, v, rel_t, rel_h, rel_w, tuple(k_shape), scale,
                                     residual)


CVT_ROWS = 64        # query rows per tile of the bf16 K7 kernel (16 per consumer warp)
CVT_MAX_S = 128      # keys the kernels take (the TPU kernel's 128 lanes)
CVT_MAX_STAGES = 4   # q tile buffers of a CTA
CVT_SMEM_TWO = 115_712  # shared memory per CTA when two share an SM (228 KB less 1 KB each)


@dataclasses.dataclass(frozen=True)
class CvtPlan:
    """Geometry of one bf16 K7 launch (`cvt_plan` in csrc/cvt_attention.cu,
    which the entry computes itself): keys padded to `sp`, heads split into
    `groups` (a tile is 64 rows of one batch item and one head group, whose
    columns span `chunks` 32-column TMA boxes), `head_ways` consumer warps
    per 16 rows (each a share of the group's heads), `threads` per CTA (the
    consumers and a producer warp), `stages` q tile buffers, `per_sm` CTAs
    per SM, `smem` bytes per CTA; `tiles` tiles in all (`row_tiles` per
    batch item and group), walked by `ctas` persistent CTAs in contiguous
    ranges."""

    sp: int
    groups: int
    head_ways: int
    threads: int
    chunks: int
    stages: int
    per_sm: int
    smem: int
    row_tiles: int
    tiles: int
    ctas: int


def cvt_smem(chunks: int, sp: int, stages: int) -> int:
    """Shared memory of one bf16 K7 CTA, as `cvt_smem` in
    csrc/cvt_attention.cu: the q tile buffers, k and v, the mbarriers (full
    and empty per buffer, one for k/v) and 1024 bytes to align the base."""
    return stages * chunks * CVT_ROWS * 64 + 2 * chunks * sp * 64 + (2 * stages + 1) * 8 + 1024


@functools.lru_cache(maxsize=None)
def cvt_plan(Bt: int, L: int, S: int, C: int, heads: int) -> CvtPlan:
    """The bf16 K7 kernel's geometry: keys padded to a power of two >= 16;
    heads split into groups (a group short of all heads spans a multiple of
    32 columns) where whole rows' k and v do not fit beside a tile, and
    further while the tiles do not give every SM one; two consumer warps per
    16 rows where a group holds two heads or more; two CTAs per SM with at
    least two buffers each where they fit, else one with as many buffers
    (up to four) as fit. Raises ValueError on what the kernel does not
    take."""
    hd = C // heads if heads > 0 else 0
    if not 1 <= S <= CVT_MAX_S:
        raise ValueError(f"cvt_cross_attention: S = {S} keys not in 1..{CVT_MAX_S}")
    if hd < 16 or hd % 16 or hd * heads != C:
        raise ValueError(f"cvt_cross_attention: C = {C} over {heads} heads is not a head_dim "
                         "that is a multiple of 16")
    if Bt < 1 or L < 1:
        raise ValueError(f"cvt_cross_attention: Bt {Bt}, L {L}")
    sp = 16
    while sp < S:
        sp *= 2
    row_tiles = -(-L // CVT_ROWS)
    groups = 0
    for g in range(1, heads + 1):
        if heads % g or (g > 1 and heads // g * hd % 32):
            continue
        if cvt_smem(-(-(heads // g * hd) // 32), sp, 1) > SMEM_MAX:
            continue
        groups = g
        if Bt * g * row_tiles >= NUM_SMS:
            break
    if not groups:
        raise ValueError(f"cvt_cross_attention: S = {S} keys at head_dim {hd} need more than "
                         f"{SMEM_MAX} bytes of shared memory for one head's k and v")
    hg = heads // groups
    chunks, ways = -(-(hg * hd) // 32), 2 if hg >= 2 else 1
    fits = [(st, 2) for st in range(CVT_MAX_STAGES, 1, -1)
            if cvt_smem(chunks, sp, st) <= CVT_SMEM_TWO]
    fits += [(st, 1) for st in range(CVT_MAX_STAGES, 0, -1)
             if cvt_smem(chunks, sp, st) <= SMEM_MAX]
    stages, per_sm = fits[0]
    tiles = Bt * groups * row_tiles
    return CvtPlan(sp, groups, ways, 32 * (4 * ways + 1), chunks, stages, per_sm,
                   cvt_smem(chunks, sp, stages), row_tiles, tiles, min(tiles, per_sm * NUM_SMS))


@dataclasses.dataclass(frozen=True)
class CvtF32Plan:
    """Geometry of one f32 K7 launch (`cvt_f32_plan` in
    csrc/cvt_attention.cu, which the entry computes itself): keys padded to
    `sp` (8-128), tiles of `tile_rows` rows (64, else 32 or 16 where a
    64-row tile does not fit beside one head's k and v) of one batch item
    and head group (`groups`, `chunks` 32-column TMA boxes), `head_ways`
    consumer warps per 16 rows, `threads` per CTA (the consumers and a
    producer warp), `stages` q tile buffers, `per_sm` CTAs per SM, `smem`
    bytes per CTA; `tiles` tiles in all (`row_tiles` per batch item and
    group), walked by `ctas` persistent CTAs in contiguous ranges."""

    sp: int
    groups: int
    head_ways: int
    threads: int
    chunks: int
    tile_rows: int
    stages: int
    per_sm: int
    smem: int
    row_tiles: int
    tiles: int
    ctas: int


def cvt_f32_smem(chunks: int, sp: int, tile_rows: int, stages: int) -> int:
    """Shared memory of one f32 K7 CTA, as `cvt_f32_smem` in
    csrc/cvt_attention.cu: the q tile buffers (128 bytes per row and box), k
    and v (sp rows of 32 chunks + 4 floats each), the mbarriers (full and
    empty per buffer) and 1024 bytes to align the base."""
    return stages * chunks * tile_rows * 128 + 2 * sp * (32 * chunks + 4) * 4 + 2 * stages * 8 + 1024


@functools.lru_cache(maxsize=None)
def cvt_f32_plan(Bt: int, L: int, S: int, C: int, heads: int) -> CvtF32Plan:
    """The f32 K7 kernel's geometry: keys padded to a power of two >= 8;
    64-row tiles, else 32, else 16, the first that fits one head's k and v
    beside one tile; heads split into groups as `cvt_plan` splits them; two
    consumer warps per 16 rows where a group holds two heads or more; two
    CTAs per SM with at least two buffers each where they fit, else one
    with as many buffers (up to four) as fit. Raises ValueError on what the
    kernel does not take: S outside 1..128, a head_dim not a multiple of 8,
    or one head's k and v beyond one CTA's shared memory beside a 16-row
    tile."""
    hd = C // heads if heads > 0 else 0
    if not 1 <= S <= CVT_MAX_S:
        raise ValueError(f"cvt_cross_attention: S = {S} keys not in 1..{CVT_MAX_S}")
    if hd < 8 or hd % 8 or hd * heads != C:
        raise ValueError(f"cvt_cross_attention: C = {C} over {heads} heads is not a head_dim "
                         "that is a multiple of 8 (f32)")
    if Bt < 1 or L < 1:
        raise ValueError(f"cvt_cross_attention: Bt {Bt}, L {L}")
    sp = 8
    while sp < S:
        sp *= 2
    for tr in (64, 32, 16):
        row_tiles = -(-L // tr)
        groups = 0
        for g in range(1, heads + 1):
            if heads % g or (g > 1 and heads // g * hd % 32):
                continue
            if cvt_f32_smem(-(-(heads // g * hd) // 32), sp, tr, 1) > SMEM_MAX:
                continue
            groups = g
            if Bt * g * row_tiles >= NUM_SMS:
                break
        if not groups:
            continue
        hg = heads // groups
        chunks, ways = -(-(hg * hd) // 32), 2 if hg >= 2 else 1
        fits = [(st, 2) for st in range(CVT_MAX_STAGES, 1, -1)
                if cvt_f32_smem(chunks, sp, tr, st) <= CVT_SMEM_TWO]
        fits += [(st, 1) for st in range(CVT_MAX_STAGES, 0, -1)
                 if cvt_f32_smem(chunks, sp, tr, st) <= SMEM_MAX]
        stages, per_sm = fits[0]
        tiles = Bt * groups * row_tiles
        return CvtF32Plan(sp, groups, ways, 32 * (tr // 16 * ways + 1), chunks, tr, stages,
                          per_sm, cvt_f32_smem(chunks, sp, tr, stages), row_tiles, tiles,
                          min(tiles, per_sm * NUM_SMS))
    raise ValueError(f"cvt_cross_attention: S = {S} keys at head_dim {hd} need more than "
                     f"{SMEM_MAX} bytes of shared memory for one head's k and v (f32)")


def reference_cvt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """K7's plain version (the einsum path of JAX `reference_cvt_attention`,
    attention.py:881), rounding as the TPU kernel does: f32 scores times
    the scale, softmax in f32, p rounded to v's dtype, f32 accumulation,
    one rounding to q's dtype."""
    Bt, L, C = q.shape
    hd = C // num_heads
    f = K.acc_dtype(q.dtype)
    s = torch.einsum("blhd,bthd->bhlt", q.reshape(Bt, L, num_heads, hd).to(f),
                     k.reshape(Bt, -1, num_heads, hd).to(f)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).to(f)
    out = torch.einsum("bhlt,bthd->blhd", p, v.reshape(Bt, -1, num_heads, hd).to(f))
    return out.reshape(Bt, L, C).to(q.dtype)


def cvt_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head for q (Bt, L, C) and k, v (Bt, S,
    C): kernel K7 on CUDA (bf16, or its f32 instance for f32), the plain
    version on the CPU. Eval only. The C entry refuses, and `launch` raises
    on, what the kernels do not take: S outside 1..128; a head_dim not a
    multiple of 16 (bf16) or of 8 (f32, whose TMA row stride C * 4 bytes
    must be a multiple of 16); one head's k and v beyond one CTA's shared
    memory beside a tile (bf16: 64 rows; f32: 16 rows, which refuses head_dim
    384 at more than 64 keys and head_dim 192 at none). `cvt_plan` and
    `cvt_f32_plan` mirror the checks."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("cvt_cross_attention (kernel K7) is eval-only and has no "
                           "backward; call it under torch.no_grad() or take the einsum path")
    K.refuse_dtensor("cvt_cross_attention", q, k, v)
    if q.device.type == "cpu":
        return reference_cvt_attention(q, k, v, num_heads, scale)
    K.require_cuda(q, "cvt_cross_attention")
    Bt, L, C = q.shape
    S = k.shape[1]
    K.check(tuple(k.shape) == (Bt, S, C) and tuple(v.shape) == (Bt, S, C),
            f"cvt_cross_attention: k {tuple(k.shape)}, v {tuple(v.shape)} for q "
            f"{tuple(q.shape)}")
    dt = _card_dtype("cvt_cross_attention", q)
    _check_tensors("cvt_cross_attention", q.device, [("q", q, dt), ("k", k, dt), ("v", v, dt)])
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kern = CVT_F32_KERNEL if dt == torch.float32 else CVT_KERNEL
    kern.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), Bt, L, S, C,
                num_heads, float(scale), K.stream())
    return out
