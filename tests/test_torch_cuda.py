"""The port's thirteen Hopper kernels and their f32 instances against their
plain PyTorch versions, on the card, and autograd through them. Every test
here needs a CUDA device and nvcc: the `cuda` marker
names them and the `card` fixture skips them where
`torch.cuda.is_available()` is false. This file imports no JAX (the card's
machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances compare in the working dtype on the same inputs. In bf16 the
kernel and the plain version round the same f32 values at other points
(the flash softmax, the order of sums), so they may differ by one bf16 ulp
of the output: |d| <= 1e-2 + 1e-2 * |plain| covers one ulp at any
magnitude. In f32 the difference is the order of f32 sums: 1e-5; K6's
parameter gradients sum ~1000 rows in another order: 1e-4 relative. K12's
f32 bias gradients come from dS as bf16 hi + lo parts on the tensor cores
(~16 mantissa bits) and p recomputed from the row logsumexp: they are held
to the bf16 bound too. The attention backward kernels read the forward's
logsumexp, so each test takes it from the forward kernel first. The f32
instances (f32 models) are held to 1e-5 like every f32 kernel, K8's
against its plain version computed in f64, within the larger of 1e-5 and
twice the f32 plain version's own distance: that plain version is one f32
conv2d, and the algorithm cuDNN picks for it sits up to ~2.4e-5 from f64
at C = 768.
"""

import dataclasses

import pytest
import torch

from diff_sal_tpu_torch.ops import attention as t_attn
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import layernorm as t_ln
from diff_sal_tpu_torch.ops import mlp as t_mlp
from diff_sal_tpu_torch.ops import pool as t_pool
from diff_sal_tpu_torch.ops import resize as t_resize

pytestmark = pytest.mark.cuda

BF16_TOL = dict(atol=1e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)


def _check(out, plain, dtype):
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.float(), plain.float(), **tol)


def _check_head(out, xs, out_hw, k, b):
    """K8's output against its plain version: bf16 at the bf16 tolerance,
    f32 against the plain version in f64 within max(1e-5, twice the f32
    plain version's own distance from it)."""
    plain = t_resize.resize_sum_conv_relu_plain
    if out.dtype == torch.bfloat16:
        return _check(out, plain(xs, out_hw, k, b), torch.bfloat16)
    ref = plain([x.double() for x in xs], out_hw, k.double(), b.double())
    own = float((plain(xs, out_hw, k, b).double() - ref).abs().max())
    torch.cuda.synchronize()
    torch.testing.assert_close(out.double(), ref, atol=max(F32_TOL["atol"], 2 * own), rtol=0)


@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("residual", [True, False])
def test_bias_attention_kernel(card, D, residual):
    g = torch.Generator().manual_seed(D)
    k_shape = (8, 7, 12)  # MViT block 0's key grid: Lk = 673
    B, Lq, H = 2, 1000, 2
    Lk = 1 + 8 * 7 * 12
    q, k, v = (_randn(g, B, n, H * D) for n in (Lq, Lk, Lk))
    rel = _randn(g, B, Lq, H, 27, scale=0.5)
    before = t_attn.KERNEL.launches
    out = t_attn.bias_attention(q, k, v, rel, k_shape, H, D ** -0.5, residual)
    assert t_attn.KERNEL.launches == before + 1
    _check(out, t_attn.bias_attention_plain(q, k, v, rel, k_shape, H, D ** -0.5, residual),
           torch.bfloat16)


# MViTv2-small's sixteen blocks at 224x384x16 give the forward seven distinct
# shapes: (heads, Lq of K1, key grid); B=2, head_dim 96 throughout
MVIT_BLOCKS = [(1, 43008, (8, 7, 12)), (2, 10752, (8, 14, 24)), (2, 10752, (8, 7, 12)),
               (4, 2688, (8, 14, 24)), (4, 2688, (8, 7, 12)), (8, 672, (8, 14, 24)),
               (8, 672, (8, 7, 12))]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("H,Lq,k_shape", MVIT_BLOCKS)
def test_bias_attention_kernel_block_shapes(card, H, Lq, k_shape, residual):
    """K1 at every MViT block shape, full Lq, B=2."""
    g = torch.Generator().manual_seed(Lq + H)
    B, D = 2, 96
    Lk = 1 + k_shape[0] * k_shape[1] * k_shape[2]
    q, k, v = (_randn(g, B, n, H * D) for n in (Lq, Lk, Lk))
    rel = _randn(g, B, Lq, H, sum(k_shape), scale=0.5)
    before = t_attn.KERNEL.launches
    out = t_attn.bias_attention_fwd(q, k, v, rel, k_shape, H, D ** -0.5, residual)
    assert t_attn.KERNEL.launches == before + 1
    _check(out, t_attn.bias_attention_plain(q, k, v, rel, k_shape, H, D ** -0.5, residual),
           torch.bfloat16)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("H,Lq,k_shape", MVIT_BLOCKS)
def test_fused_bias_attention_kernel_block_shapes(card, H, Lq, k_shape, residual):
    """K12 at every MViT block shape: B*heads batches, the cls row at row 0
    of q (Lq + 1 rows), f32 bias terms, no residual on row 0."""
    g = torch.Generator().manual_seed(Lq + H + 7)
    q, k, v, rels = _k12_args(g, 2 * H, Lq + 1, k_shape)
    before = t_attn.CLS_KERNEL.launches
    out = t_attn.fused_bias_attention_fwd(q, k, v, *rels, k_shape, 96 ** -0.5, residual)
    assert t_attn.CLS_KERNEL.launches == before + 1
    ref = t_attn.fused_bias_attention_plain(q, k, v, *rels, k_shape, 96 ** -0.5, residual)
    _check(out, ref, torch.bfloat16)
    _check(out[:, 0], ref[:, 0], torch.bfloat16)


def test_block_shapes_take_both_plans(card):
    """The seven block shapes at B=2 launch both geometries: 128 rows per
    CTA where that fills the card, 64 at blocks 14-15 (96 CTAs at 128)."""
    rows = {t_attn.fwd_plan(2, H, Lq, 1 + ks[0] * ks[1] * ks[2], 96, ks).rows
            for H, Lq, ks in MVIT_BLOCKS}
    assert rows == {64, 128}


@pytest.mark.parametrize("C", [96, 192, 384, 512, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel(card, C, dtype):
    g = torch.Generator().manual_seed(C)
    x = _randn(g, 3, 333, C, dtype=dtype, scale=2.0) + 1.0
    w, b = _randn(g, C, dtype=torch.float32) + 1, _randn(g, C, dtype=torch.float32)
    _check(t_ln.layer_norm(x, w, b, 1e-6), t_ln.layer_norm_plain(x, w, b, 1e-6), dtype)


def test_layer_norm_kernel_real_dim(card):
    g = torch.Generator().manual_seed(0)
    x = torch.nn.functional.pad(_randn(g, 100, 96, dtype=torch.float32), (0, 32))
    w, b = _randn(g, 96, dtype=torch.float32), _randn(g, 96, dtype=torch.float32)
    out = t_ln.layer_norm(x, w, b, 1e-6, real_dim=96)
    _check(out, t_ln.layer_norm_plain(x, w, b, 1e-6, real_dim=96), torch.float32)
    assert float(out[:, 96:].abs().max()) == 0.0


# K2's (rows, C) on the paths at 224x384x16, B=2: MViT's spatial rows at
# the four stages, its cls rows, the per-head norms over the token-concat
# rows (2 * 43009), the decoder's first stage and the audio branch
LN_PATH_SHAPES = [(86016, 96), (86018, 96), (21504, 192), (5376, 384), (1344, 768),
                  (2, 96), (2, 768), (18, 512), (672, 768)]


@pytest.mark.parametrize("R,C", LN_PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_path_shapes(card, R, C, dtype):
    """K2 at every path shape: one launch, the bulk path (ln_plan), the
    plain version's values."""
    g = torch.Generator().manual_seed(R + C)
    x = _randn(g, R, C, dtype=dtype, scale=2.0) + 0.5
    w, b = _randn(g, C, dtype=torch.float32) + 1, _randn(g, C, dtype=torch.float32)
    assert t_ln.ln_plan(R, C, dtype, x.data_ptr() % 16 == 0).bulk
    before = t_ln.KERNEL.launches
    out = t_ln.layer_norm_fwd(x, w, b, 1e-6)
    assert t_ln.KERNEL.launches == before + 1
    _check(out, t_ln.layer_norm_plain(x, w, b, 1e-6), dtype)


@pytest.mark.parametrize("R", [1, 2, 65, 1001, 20003])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_ragged_rows_and_real_dim(card, R, dtype):
    """A row count of 1-2 (MViT's cls rows) or not a multiple of the tile,
    over a zero-padded axis (real_dim < C): the pad channels are written 0."""
    g = torch.Generator().manual_seed(R)
    x = torch.nn.functional.pad(_randn(g, R, 96, dtype=dtype) + 1.0, (0, 32))
    w, b = _randn(g, 96, dtype=torch.float32), _randn(g, 96, dtype=torch.float32)
    out = t_ln.layer_norm_fwd(x, w, b, 1e-6, real_dim=96)
    _check(out, t_ln.layer_norm_plain(x, w, b, 1e-6, real_dim=96), dtype)
    assert float(out[:, 96:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_takes_unaligned_rows_in_its_row_kernel(card, dtype):
    """An input that does not start on 16 bytes (a view one element into its
    storage), or rows that are not whole 16-byte vectors (200 or 392
    bytes), cannot be bulk-copied: the same entry runs its row kernel, one
    K2 launch, never the plain version."""
    g = torch.Generator().manual_seed(5)
    misaligned = _randn(g, 1000 * 96 + 1, dtype=dtype)[1:].view(1000, 96)
    ragged = _randn(g, 300, 100 if dtype == torch.bfloat16 else 98, dtype=dtype)
    for x in (misaligned, ragged):
        R, C = x.shape
        assert x.is_contiguous() and not t_ln.ln_plan(R, C, dtype, x.data_ptr() % 16 == 0).bulk
        w, b = _randn(g, C, dtype=torch.float32), _randn(g, C, dtype=torch.float32)
        before = t_ln.KERNEL.launches
        out = t_ln.layer_norm_fwd(x, w, b, 1e-6)
        assert t_ln.KERNEL.launches == before + 1
        _check(out, t_ln.layer_norm_plain(x, w, b, 1e-6), dtype)


@pytest.mark.parametrize("C,R", [(768, 840), (384, 3360), (192, 1000), (96, 5000)])
@pytest.mark.parametrize("act", ["tanh", "exact"])
def test_block_tail_kernel(card, C, R, act):
    """The decoder's widths and row counts at B=2 (R ragged against 32)."""
    g = torch.Generator().manual_seed(C + R)
    Hd = 2 * C
    skip, attn = _randn(g, R, C), _randn(g, R, C)
    lw, lb = _randn(g, C, dtype=torch.float32) + 1, _randn(g, C, dtype=torch.float32, scale=0.1)
    w1, b1 = _randn(g, Hd, C, scale=C ** -0.5), _randn(g, Hd, dtype=torch.float32, scale=0.1)
    w2, b2 = _randn(g, C, Hd, scale=Hd ** -0.5), _randn(g, C, dtype=torch.float32, scale=0.1)
    args = (skip, attn, lw, lb, w1, b1, w2, b2, 1e-6, act)
    _check(t_mlp.block_tail(*args), t_mlp.block_tail_plain(*args), torch.bfloat16)


def _tail_args(g, R, C, act):
    Hd = 2 * C
    skip, attn = _randn(g, R, C), _randn(g, R, C)
    lw, lb = _randn(g, C, dtype=torch.float32) + 1, _randn(g, C, dtype=torch.float32, scale=0.1)
    w1, b1 = _randn(g, Hd, C, scale=C ** -0.5), _randn(g, Hd, dtype=torch.float32, scale=0.1)
    w2, b2 = _randn(g, C, Hd, scale=Hd ** -0.5), _randn(g, C, dtype=torch.float32, scale=0.1)
    return (skip, attn, lw, lb, w1, b1, w2, b2, 1e-6, act)


# each decoder width with a small R (one row tile, split over the hidden
# axis) and the decoder's R at B=2 with eight frames (C = 768: 1344 rows,
# the hidden split; C = 96: 86016 rows, 1344 CTAs)
TAIL_SHAPES = [(768, 40), (768, 1344), (768, 2688), (384, 100), (384, 5376), (192, 64),
               (192, 21504), (96, 1), (96, 86016)]


@pytest.mark.parametrize("C,R", TAIL_SHAPES)
@pytest.mark.parametrize("act", ["tanh", "exact"])
def test_block_tail_kernel_decoder_shapes(card, C, R, act):
    """The wgmma K3 at each decoder width, small and large R, both GELUs:
    one launch (with its split reduction where the plan splits the hidden
    axis), the plain version's values."""
    g = torch.Generator().manual_seed(3 * C + R)
    args = _tail_args(g, R, C, act)
    before = t_mlp.KERNEL.launches
    out = t_mlp.block_tail(*args)
    assert t_mlp.KERNEL.launches == before + 1
    _check(out, t_mlp.block_tail_plain(*args), torch.bfloat16)


def test_block_tail_shapes_take_every_plan(card):
    """The shapes above launch one and two consumer warpgroups, with and
    without the hidden split, and w1 tiles of one and two boxes."""
    plans = [t_mlp.tail_plan(R, C, 2 * C) for C, R in TAIL_SHAPES]
    assert {p.wgs for p in plans} == {1, 2}
    assert {p.k_splits > 1 for p in plans} == {False, True}
    assert {p.kb for p in plans} == {1, 2}


@pytest.mark.parametrize("C,R", [(768, 1344), (768, 40), (384, 5376), (96, 5000)])
def test_block_tail_kernel_is_deterministic(card, C, R):
    """Two launches give the same bits: the hidden splits' partial sums are
    added in a fixed order, no atomics."""
    g = torch.Generator().manual_seed(C - R)
    args = _tail_args(g, R, C, "tanh")
    a = t_mlp.block_tail(*args)
    b = t_mlp.block_tail(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


DECODER_MAPS = [(7, 12), (14, 24), (28, 48), (56, 96)]
# the plan test's shapes (tests/test_torch_resize_plan.py): (B, out_hw,
# inputs, C): the decoder's sum, the small models' (phase 10, phase 5),
# ragged outputs, n = 1..4, inputs larger than the output, a map wide enough
# that the plan splits its columns
RESIZE_CASES = [(2, (112, 192), DECODER_MAPS, 768),
                (2, (64, 48), [(4, 3), (8, 6), (16, 12), (32, 24)], 768),
                (2, (32, 48), [(2, 3), (4, 6), (8, 12), (16, 24)], 96),
                (2, (37, 29), [(5, 7), (11, 3)], 16), (1, (9, 50), [(3, 4)], 128),
                (3, (21, 35), [(40, 70), (7, 9)], 32),
                (1, (7, 11), [(20, 30), (7, 11), (3, 5)], 24), (2, (1, 1), [(1, 1)], 8),
                (1, (5, 600), [(2, 900), (5, 3)], 40)]
RESIZE_IDS = ["B{}-{}x{}-n{}-C{}".format(c[0], *c[1], len(c[2]), c[3]) for c in RESIZE_CASES]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,out_hw,shapes,C", RESIZE_CASES, ids=RESIZE_IDS)
def test_resize_sum_kernel(card, dtype, B, out_hw, shapes, C):
    """K4 at the plan test's shapes, both dtypes, one launch each."""
    g = torch.Generator().manual_seed(C + B)
    xs = [_randn(g, B, h, w, C, dtype=dtype) for h, w in shapes]
    before = t_resize.KERNEL.launches
    out = t_resize.bilinear_resize_sum(xs, out_hw)
    assert t_resize.KERNEL.launches == before + 1
    _check(out, t_resize.bilinear_resize_sum_plain(xs, out_hw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_sum_kernel_is_deterministic(card, dtype):
    """Two launches at the decoder's shape give the same bits: every output
    is summed by one thread in a fixed order, no atomics."""
    g = torch.Generator().manual_seed(13)
    xs = [_randn(g, 2, h, w, 768, dtype=dtype) for h, w in DECODER_MAPS]
    a = t_resize.bilinear_resize_sum(xs, (112, 192))
    b = t_resize.bilinear_resize_sum(xs, (112, 192))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_sum_kernel_takes_larger_inputs(card, dtype):
    """K4 with inputs larger than the output (a band's row taps skip input
    rows, a tile's columns span more input columns than it has outputs)
    beside smaller ones, and one far wider than the output."""
    g = torch.Generator().manual_seed(14)
    for shapes, out_hw in (([(40, 70), (7, 9), (21, 35)], (21, 35)), ([(3, 2000)], (4, 50))):
        xs = [_randn(g, 2, h, w, 64, dtype=dtype) for h, w in shapes]
        _check(t_resize.bilinear_resize_sum(xs, out_hw),
               t_resize.bilinear_resize_sum_plain(xs, out_hw), dtype)


def test_resize_kernels_refuse_what_they_do_not_take(card):
    """K4 and K9 raise on a dtype, a channel count or an input count they do
    not take; they never fall back to the plain version."""
    g = torch.Generator().manual_seed(15)
    with pytest.raises(ValueError):  # f16
        t_resize.bilinear_resize_sum([_randn(g, 1, 3, 4, 16, dtype=torch.float16)], (6, 8))
    with pytest.raises(ValueError):  # bf16 channels in groups of 8
        t_resize.bilinear_resize_sum([_randn(g, 1, 3, 4, 12)], (6, 8))
    with pytest.raises(ValueError):  # five inputs
        t_resize.bilinear_resize_sum([_randn(g, 1, 3, 4, 16)] * 5, (6, 8))
    xs, k, b = _head_args(g, [(3, 4)], 32, 12)
    with pytest.raises(ValueError):  # K9 bf16: O % 8
        t_resize.resize_sum_conv_relu_phase(xs, (6, 8), k, b)
    xs, k, b = _head_args(g, [(3, 4)], 32, 136)
    with pytest.raises(ValueError):  # K9: O <= 128
        t_resize.resize_sum_conv_relu_phase(xs, (6, 8), k, b)


def _close_bf16(out, plain):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("Lq,k_shape,H", [(1500, (8, 7, 12), 1), (700, (8, 14, 24), 2),
                                         (672, (8, 14, 24), 8)])
def test_bias_attention_bwd_kernel(card, Lq, k_shape, H, residual):
    """MViT blocks 0, 1 and 14 of the train step (Lk = 673, 2689, 2689),
    Lq cut down and ragged against the 64-row tiles."""
    g = torch.Generator().manual_seed(Lq + H)
    D, B = 96, 2
    kt, kh, kw = k_shape
    Lk = 1 + kt * kh * kw
    q, k, v, go = (_randn(g, B, n, H * D) for n in (Lq, Lk, Lk, Lq))
    rel = _randn(g, B, Lq, H, kt + kh + kw, scale=0.5)
    args = (q, k, v, rel, go, k_shape, H, D ** -0.5, residual)
    lse = t_attn.bias_attention_fwd(q, k, v, rel, k_shape, H, D ** -0.5, return_lse=True)[1]
    before = t_attn.BWD_KERNEL.launches
    got = t_attn.bias_attention_bwd(*args, lse=lse)
    assert t_attn.BWD_KERNEL.launches == before + 1
    ref = t_attn.bias_attention_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "drel"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close_bf16(a, b)


@pytest.mark.parametrize("C", [96, 192, 384, 512, 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel(card, C, dtype):
    g = torch.Generator().manual_seed(C + 1)
    x = _randn(g, 3, 333, C, dtype=dtype, scale=2.0) + 1.0
    go = _randn(g, 3, 333, C, dtype=dtype)
    w = _randn(g, C, dtype=torch.float32) + 1
    before = t_ln.BWD_KERNEL.launches
    dx, dw, db = t_ln.layer_norm_bwd(x, go, w, 1e-6)
    assert t_ln.BWD_KERNEL.launches == before + 1
    rx, rw, rb = t_ln.layer_norm_bwd_plain(x, go, w, 1e-6)
    _check(dx, rx, dtype)
    for a, b in ((dw, rw), (db, rb)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_layer_norm_bwd_kernel_real_dim(card):
    g = torch.Generator().manual_seed(2)
    x = torch.nn.functional.pad(_randn(g, 100, 96, dtype=torch.float32), (0, 32))
    go, w = _randn(g, 100, 128, dtype=torch.float32), _randn(g, 96, dtype=torch.float32)
    got = t_ln.layer_norm_bwd(x, go, w, 1e-6, real_dim=96)
    ref = t_ln.layer_norm_bwd_plain(x, go, w, 1e-6, real_dim=96)
    assert got[1].shape == (96,) and got[2].shape == (96,)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# K6 at the training paths' (rows, C): MViT's four stages at B = 4 with
# the cls row, its cls rows alone, the decoder's first stage, the audio
# branch, and ragged counts
LN_BWD_PATH_SHAPES = [(172036, 96), (43009, 192), (10753, 384), (2689, 768), (1, 96),
                      (2, 768), (4, 384), (18, 512), (1000, 512), (673, 768)]


def _ln_bwd_inputs(g, R, C, dtype):
    x = _randn(g, R, C, dtype=dtype, scale=2.0) + 1.0
    go = _randn(g, R, C, dtype=dtype)
    w = _randn(g, C, dtype=torch.float32) + 1
    return x, go, w


@pytest.mark.parametrize("R,C", LN_BWD_PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel_path_shapes(card, R, C, dtype):
    """K6 at every path shape: one launch (the bulk path, `ln_bwd_plan`,
    and the reduction of the CTAs' partial rows), dx in the
    working dtype's tolerance, the f32 parameter gradients within 1e-4 of
    the plain version's (sums over up to 172036 rows in another order,
    held as phase 6 holds them: 1e-5 of the sum of the terms' magnitudes
    per channel, and 1e-4 relative)."""
    g = torch.Generator().manual_seed(R + C)
    x, go, w = _ln_bwd_inputs(g, R, C, dtype)
    assert t_ln.ln_bwd_plan(R, C, dtype).bulk
    before = t_ln.BWD_KERNEL.launches
    dx, dw, db = t_ln.layer_norm_bwd(x, go, w, 1e-6)
    assert t_ln.BWD_KERNEL.launches == before + 1
    rx, rw, rb = t_ln.layer_norm_bwd_plain(x, go, w, 1e-6)
    _check(dx, rx, dtype)
    xf, gf = x.float(), go.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mags = ((gf * (xf - mean) * torch.rsqrt(var + 1e-6)).abs().sum(0), gf.abs().sum(0))
    for a, b, mag in ((dw, rw, mags[0]), (db, rb, mags[1])):
        assert a.shape == b.shape == (C,)
        assert bool(((a - b).abs() <= 1e-5 * mag + 1e-4 * b.abs()).all()), float(
            (a - b).abs().max())


@pytest.mark.parametrize("R", [1, 2, 65, 1001, 20003])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel_ragged_rows_and_real_dim(card, R, dtype):
    """1-2 rows (one CTA, which writes d_weight and d_bias itself) and row
    counts off the tiles, over a zero-padded axis (real_dim < C): the pad
    lanes of dx get the mean coupling, the parameter gradients have
    real_dim entries."""
    g = torch.Generator().manual_seed(R + 7)
    x = torch.nn.functional.pad(_randn(g, R, 96, dtype=dtype) + 1.0, (0, 32))
    go = _randn(g, R, 128, dtype=dtype)
    w = _randn(g, 96, dtype=torch.float32) + 1
    dx, dw, db = t_ln.layer_norm_bwd(x, go, w, 1e-6, real_dim=96)
    rx, rw, rb = t_ln.layer_norm_bwd_plain(x, go, w, 1e-6, real_dim=96)
    _check(dx, rx, dtype)
    assert dw.shape == db.shape == (96,)
    torch.testing.assert_close(dw, rw, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(db, rb, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel_takes_unaligned_rows_in_its_row_kernel(card, dtype):
    """x or g one element into its storage, or rows that are not whole
    16-byte vectors: the same entry runs its row kernel (the same partial
    rows and reduction), one K6 launch, never the plain version."""
    g = torch.Generator().manual_seed(6)
    R, C = 5000, 96
    x, go, w = _ln_bwd_inputs(g, R, C, dtype)

    def shifted(t):  # the same values one element into a larger storage
        s = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
        return s.copy_(t)
    cases = [(shifted(x), go, w), (x, shifted(go), w),
             _ln_bwd_inputs(g, 3000, 100 if dtype == torch.bfloat16 else 98, dtype)]
    for xx, gg, ww in cases:
        RR, CC = xx.shape
        aligned = xx.data_ptr() % 16 == 0 and gg.data_ptr() % 16 == 0
        assert xx.is_contiguous() and gg.is_contiguous()
        assert not t_ln.ln_bwd_plan(RR, CC, dtype, aligned).bulk
        before = t_ln.BWD_KERNEL.launches
        dx, dw, db = t_ln.layer_norm_bwd(xx, gg, ww, 1e-6)
        assert t_ln.BWD_KERNEL.launches == before + 1
        rx, rw, rb = t_ln.layer_norm_bwd_plain(xx, gg, ww, 1e-6)
        _check(dx, rx, dtype)
        torch.testing.assert_close(dw, rw, atol=1e-3, rtol=1e-4)
        torch.testing.assert_close(db, rb, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("R,C", [(172036, 96), (2689, 768), (1000, 512), (3, 384)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel_is_deterministic(card, R, C, dtype):
    """Three launches give the same bits, dx and the parameter gradients:
    the CTAs' partial rows are added in a fixed order, no atomics."""
    g = torch.Generator().manual_seed(R - C)
    x, go, w = _ln_bwd_inputs(g, R, C, dtype)
    outs = [t_ln.layer_norm_bwd(x, go, w, 1e-6) for _ in range(3)]
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_kernel_wrappers_record_a_backward_or_raise(card):
    """On CUDA tensors that require grad, K1, K2 and K4 return a result
    with a grad_fn whose backward runs K5, K6 and the plain resize
    backward; K3 raises."""
    g = torch.Generator().manual_seed(3)
    rg = lambda t: t.requires_grad_()  # noqa: E731
    q, k, v = (rg(_randn(g, 1, n, 96)) for n in (64, 13, 13))
    rel = rg(_randn(g, 1, 64, 1, 8))
    x = rg(_randn(g, 10, 96))
    w, b = rg(_randn(g, 96, dtype=torch.float32)), rg(_randn(g, 96, dtype=torch.float32))
    xs = [rg(_randn(g, 1, 3, 4, 16))]
    outs = [t_attn.bias_attention(q, k, v, rel, (1, 3, 4), 1, 0.1),
            t_ln.layer_norm(x, w, b), t_resize.bilinear_resize_sum(xs, (6, 8))]
    assert all(o.grad_fn is not None for o in outs)
    K.reset_launch_counts()
    sum(o.float().sum() for o in outs).backward()
    counts = K.launch_counts()
    assert counts["bias_attention_bwd"] == 1 and counts["layer_norm_bwd"] == 1, counts
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v, rel, x, w, b, xs[0]))
    with pytest.raises(RuntimeError, match="eval-only"):
        t_mlp.block_tail(rg(_randn(g, 32, 96)), _randn(g, 32, 96), w, b, _randn(g, 192, 96),
                         _randn(g, 192, dtype=torch.float32), _randn(g, 96, 192), b)


def test_kernels_refuse_what_they_do_not_take(card):
    g = torch.Generator().manual_seed(1)
    q = _randn(g, 1, 10, 96, dtype=torch.float32)
    k = _randn(g, 1, 5, 96, dtype=torch.float32)
    rel = _randn(g, 1, 10, 1, 5, dtype=torch.float32)
    with pytest.raises(ValueError):  # K1 takes bf16 and f32 (its f32 instance), not f16
        t_attn.bias_attention(q.half(), k.half(), k.half(), rel.half(), (1, 2, 2), 1, 0.1)
    with pytest.raises(ValueError):  # non-contiguous rows
        t_ln.layer_norm(_randn(g, 8, 64)[:, ::2], torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError):  # K2: rows wider than MAX_C
        t_ln.layer_norm_fwd(_randn(g, 4, 1040), torch.ones(1040), torch.zeros(1040))
    with pytest.raises(ValueError):  # K2: f16
        t_ln.layer_norm_fwd(_randn(g, 4, 96).half(), torch.ones(96), torch.zeros(96))
    args = list(_tail_args(g, 64, 96, "tanh"))
    with pytest.raises(ValueError):  # K3: a width that is not whole 32-column boxes
        t_mlp.block_tail(*_tail_args(g, 64, 48, "tanh"))
    with pytest.raises(ValueError):  # K3: wider than MAX_C
        t_mlp.block_tail(*_tail_args(g, 8, 800, "tanh"))
    w1 = torch.empty(args[4].numel() + 1, dtype=torch.bfloat16, device="cuda")[1:]
    w1 = w1.view_as(args[4]).copy_(args[4])
    with pytest.raises(ValueError):  # K3: weights not 16-byte aligned (TMA)
        t_mlp.block_tail(*args[:4], w1, *args[5:])


def test_small_av_model_on_card_matches_cpu(card):
    """The whole port at the small AV size: bf16 through the kernels on the
    card against f32 through the plain versions on the CPU, same weights
    and noise. bf16 keeps ~3 significant digits, the map lies in [0, 1]:
    max|d| <= 3e-2."""
    from diff_sal_tpu_torch.config import (AudioAttnConfig, DataTransformConfig, ModelConfig,
                                           MViTConfig, SalUNetConfig, SamplingConfig,
                                           VGGishConfig)
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model

    cfg = ModelConfig(visual=MViTConfig.tiny(spatial_size=(64, 96)), audio=VGGishConfig(),
                      spatiotemp=AudioAttnConfig(), decoder=SalUNetConfig(img_size=(64, 96)))
    g = torch.Generator().manual_seed(0)
    rgb, audio = torch.randn(2, 16, 64, 96, 3, generator=g), torch.randn(2, 9, 32, 48, 1, generator=g)
    noise = torch.randn(2, 64, 96, 1, generator=g)
    args = (make_schedule(), SamplingConfig(), DataTransformConfig())
    cpu = build_model(cfg, 3, device="cpu")
    ref = sample_saliency(cpu, *args, rgb, audio, noise=noise)
    gpu = VideoSaliencyModel(dataclasses.replace(cfg, compute_dtype="bfloat16")).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(card)
    K.reset_launch_counts()
    out = sample_saliency(gpu, *args, rgb.to(card), audio.to(card), noise=noise)
    counts = K.launch_counts()
    assert all(counts[n] > 0 for n in ("bias_attention", "layer_norm", "block_tail",
                                       "bilinear_resize_sum")), counts
    assert counts["bias_attention_bwd"] == counts["layer_norm_bwd"] == 0, counts
    assert torch.isfinite(out).all()
    assert float((out.cpu() - ref).abs().max()) <= 3e-2


def test_small_av_train_step_on_card_matches_plain_on_cpu(card):
    """One training step of the small AV model (128x96, so every
    sub-network gets a gradient) in bf16: through the kernels on the card
    (K1, K2, K4 forward; K5, K6 and K4's plain backward) against the plain
    versions on the CPU, same weights, batch and draws. At random weights
    bf16 rounding alone moves these gradients by ~0.2 in relative L2 (the
    CPU's bf16 against its f32), so the check is the loss (2e-2 relative)
    and the direction of the gradient of each sub-network (cosine >= 0.9),
    with the same set of parameters receiving a gradient."""
    from diff_sal_tpu_torch.config import (AudioAttnConfig, ExperimentConfig, ModelConfig,
                                           MViTConfig, SalUNetConfig, VGGishConfig)
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    hw = (128, 96)
    cfg = ModelConfig(visual=MViTConfig.tiny(spatial_size=hw), audio=VGGishConfig(),
                      spatiotemp=AudioAttnConfig(), compute_dtype="bfloat16",
                      decoder=SalUNetConfig(img_size=hw, dropout=0.0, drop_path_rate=(0.0,) * 4))
    sd = build_model(cfg, seed=5, device="cpu").state_dict()
    g = torch.Generator().manual_seed(6)
    batch = {"rgb": torch.randn(2, 16, *hw, 3, generator=g),
             "salmap": torch.rand(2, *hw, 1, generator=g),
             "audio": torch.randn(2, 9, hw[0] // 2, hw[1] // 2, 1, generator=g)}
    draws = {"deq": torch.randn(2, *hw, 1, generator=g),
             "noise": torch.randn(2, *hw, 1, generator=g), "t": torch.tensor(300)}

    def step(device):
        m = VideoSaliencyModel(cfg).train()
        m.load_state_dict(sd)
        m.to(device)
        ecfg = ExperimentConfig(model=cfg)
        met = make_train_step(m, make_schedule(), ecfg)(make_optimizer(m, ecfg.optim, 10, 2),
                                                         batch, draws=draws)
        return float(met["total"]), {n: p.grad.float().cpu() for n, p in m.named_parameters()
                                     if p.grad is not None}

    l_cpu, g_cpu = step("cpu")
    K.reset_launch_counts()
    l_card, g_card = step(card)
    counts = K.launch_counts()
    assert counts["block_tail"] == 0 and all(
        counts[n] > 0 for n in ("bias_attention", "layer_norm", "bilinear_resize_sum",
                                "bias_attention_bwd", "layer_norm_bwd")), counts
    assert abs(l_card - l_cpu) <= 2e-2 * abs(l_cpu), (l_card, l_cpu)
    assert set(g_card) == set(g_cpu)
    for sub in ("visual_net.", "spatiotemp_net.", "decoder_net."):
        a = torch.cat([g_card[n].flatten() for n in g_card if n.startswith(sub)])
        b = torch.cat([g_cpu[n].flatten() for n in g_cpu if n.startswith(sub)])
        assert bool(torch.isfinite(a).all())
        assert float(torch.nn.functional.cosine_similarity(a, b, dim=0)) >= 0.9, sub


# ------------------------------------------------ K7, K8, K9, K11 ---------


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_depthwise_pool_kernel(card, stride, dtype):
    """K11 on a column slice of a wider tensor (as MViT pools the q or kv
    columns of its qkv output), odd H and W, against the plain version."""
    g = torch.Generator().manual_seed(sum(stride))
    qkv = _randn(g, 2, 8, 15, 27, 288, dtype=dtype)
    w = _randn(g, 3, 3, 3, 192, dtype=torch.float32, scale=0.3)
    x = qkv[..., 96:]
    before = t_pool.KERNEL.launches
    out = t_pool.depthwise_pool3d(x, w, stride)
    assert t_pool.KERNEL.launches == before + 1
    _check(out, t_pool.pool_plain(x, w, stride), dtype)


@pytest.mark.parametrize("shape,C,stride", [((8, 56, 96), 96, (1, 1, 1)),
                                            ((8, 56, 96), 192, (1, 8, 8)),
                                            ((8, 28, 48), 384, (1, 2, 2)),
                                            ((8, 14, 24), 1536, (1, 2, 2))])
def test_depthwise_pool_kernel_path_shapes(card, shape, C, stride):
    """MViT-small's pools at B=2: block 0's q and kv pools, a stage-2 kv
    pool (blocks 4-13) and block 14's q pool."""
    g = torch.Generator().manual_seed(C)
    x = _randn(g, 2, *shape, C)
    w = _randn(g, 3, 3, 3, C, dtype=torch.float32, scale=0.3)
    _check(t_pool.depthwise_pool3d(x, w, stride), t_pool.pool_plain(x, w, stride),
           torch.bfloat16)


def _mvit_pool_calls():
    """Every pool of MViT-small at 224x384x16, B=2, as its attention calls
    K11: x a column slice of the (B, T, H, W, 3 C) qkv output, C, stride."""
    from diff_sal_tpu_torch.config import ModelConfig
    from diff_sal_tpu_torch.models.mvit import block_plan

    calls = set()
    for p in block_plan(ModelConfig.audio_visual().visual):
        C, (T, H, W) = p["out_dims"], p["in_size"]
        if p["stride_q"] == p["stride_kv"]:
            calls.add(((T, H, W), C, 0, 3 * C, p["stride_q"]))
        else:
            calls.add(((T, H, W), C, 0, C, p["stride_q"]))
            calls.add(((T, H, W), C, C, 3 * C, p["stride_kv"]))
    return sorted(calls)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("thw,C,lo,hi,stride", _mvit_pool_calls())
def test_depthwise_pool_kernel_mvit_calls(card, dtype, thw, C, lo, hi, stride):
    """K11 on every pool call shape of the full-width AV model, read in
    place from the qkv tensor as MViT reads it, in both dtypes."""
    g = torch.Generator().manual_seed(C + lo + stride[1])
    qkv = _randn(g, 2, *thw, 3 * C, dtype=dtype)
    x = qkv[..., lo:hi]
    w = _randn(g, 3, 3, 3, hi - lo, dtype=torch.float32, scale=0.3)
    before = t_pool.KERNEL.launches
    out = t_pool.depthwise_pool3d(x, w, stride)
    assert t_pool.KERNEL.launches == before + 1
    _check(out, t_pool.pool_plain(x, w, stride), dtype)


@pytest.mark.parametrize("shape,stride", [((1, 1, 1, 1), (1, 1, 1)), ((1, 3, 5, 9), (1, 2, 2)),
                                          ((3, 2, 13, 7), (1, 3, 5)), ((1, 7, 4, 30), (1, 1, 2))])
def test_depthwise_pool_kernel_ragged(card, shape, stride):
    """K11 where the plan splits T unevenly, strips overhang W, T = 1 and
    strides the model does not use."""
    g = torch.Generator().manual_seed(sum(shape))
    x = _randn(g, *shape, 24, dtype=torch.float32)
    w = _randn(g, 3, 3, 3, 24, dtype=torch.float32, scale=0.3)
    _check(t_pool.depthwise_pool3d(x, w, stride), t_pool.pool_plain(x, w, stride), torch.float32)


def test_depthwise_pool_kernel_backward(card):
    """K11's output records a backward, and the gradients (the conv VJP)
    equal those of the plain version's autograd graph."""
    g = torch.Generator().manual_seed(7)
    x0 = _randn(g, 2, 4, 9, 13, 64, dtype=torch.float32)
    w0 = _randn(g, 3, 3, 3, 64, dtype=torch.float32, scale=0.3)
    go = _randn(g, 2, 4, 5, 7, 64, dtype=torch.float32)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = t_pool.depthwise_pool3d(x, w, (1, 2, 2))
    assert out.grad_fn is not None
    out.backward(go)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    t_pool.pool_plain(xr, wr, (1, 2, 2)).backward(go)
    _check(out.detach(), t_pool.pool_plain(x0, w0, (1, 2, 2)), torch.float32)
    _check(x.grad, xr.grad, torch.float32)
    torch.testing.assert_close(w.grad, wr.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("L,C", [(84, 768), (336, 384), (1344, 192), (5376, 96)])
def test_cvt_attention_kernel_path_shapes(card, L, C):
    """The decoder's four stages at B=2 (Bt = 10 frames), S = 18 keys."""
    g = torch.Generator().manual_seed(L)
    q, k, v = _randn(g, 10, L, C), _randn(g, 10, 18, C), _randn(g, 10, 18, C)
    before = t_attn.CVT_KERNEL.launches
    out = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    assert t_attn.CVT_KERNEL.launches == before + 1
    _check(out, t_attn.reference_cvt_attention(q, k, v, 2, C ** -0.5), torch.bfloat16)


@pytest.mark.parametrize("L,S,C,heads", [(50, 1, 96, 2), (1000, 18, 64, 2), (77, 64, 768, 2),
                                         (130, 33, 96, 3), (40, 128, 128, 2)])
def test_cvt_attention_kernel_ragged(card, L, S, C, heads):
    """Rows not a multiple of the 64-row CTA, one key, keys not a multiple
    of the 16-key tile, 64 keys at head_dim 384, 128 keys (the most the
    TPU kernel takes), head_dim 32 and three heads."""
    g = torch.Generator().manual_seed(L + S)
    q, k, v = _randn(g, 2, L, C), _randn(g, 2, S, C), _randn(g, 2, S, C)
    _check(t_attn.cvt_cross_attention(q, k, v, heads, C ** -0.5),
           t_attn.reference_cvt_attention(q, k, v, heads, C ** -0.5), torch.bfloat16)


HEAD_PATH = [(7, 12), (14, 24), (28, 48), (56, 96)]


def _head_args(g, shapes, C, O, dtype=torch.bfloat16):
    xs = [_randn(g, 2, h, w, C, dtype=dtype, scale=0.5) for h, w in shapes]
    k = _randn(g, 3, 3, C, O, dtype=dtype, scale=(9 * C) ** -0.5 * 2)
    return xs, k, _randn(g, O, dtype=torch.float32, scale=0.1)


@pytest.mark.parametrize("shapes,out_hw,C,O", [(HEAD_PATH, (112, 192), 768, 96),
                                               ([(5, 7), (11, 3)], (37, 29), 32, 16),
                                               ([(3, 4)], (9, 50), 48, 128)])
def test_resize_conv_relu_kernel(card, shapes, out_hw, C, O):
    """K8 at the decoder head's shapes at B=2, and at ragged sizes (H not a
    multiple of the 8-row tile, W not of the 16-column tile, one input,
    O = 128)."""
    g = torch.Generator().manual_seed(C + O)
    xs, k, b = _head_args(g, shapes, C, O)
    before = t_resize.CONV_KERNEL.launches
    out = t_resize.resize_sum_conv_relu(xs, out_hw, k, b)
    assert t_resize.CONV_KERNEL.launches == before + 1
    _check(out, t_resize.resize_sum_conv_relu_plain(xs, out_hw, k, b), torch.bfloat16)


@pytest.mark.parametrize("shapes,out_hw,C,O", [(HEAD_PATH, (112, 192), 768, 96),
                                               ([(5, 7), (11, 3)], (37, 29), 32, 16),
                                               ([(3, 4)], (9, 50), 48, 128),
                                               ([(4, 3), (8, 6), (16, 12), (32, 24)], (64, 48),
                                                768, 96)])
def test_resize_conv_relu_f32_kernel(card, shapes, out_hw, C, O):
    """K8's f32 instance (split TF32) at the head's shapes at B=2, at
    ragged sizes and at the small AV model's head (128x96), held to the
    plain version in f64; it counts as its own kernel's launch."""
    g = torch.Generator().manual_seed(C + O + 2)
    xs, k, b = _head_args(g, shapes, C, O, torch.float32)
    before, before16 = t_resize.CONV_F32_KERNEL.launches, t_resize.CONV_KERNEL.launches
    out = t_resize.resize_sum_conv_relu(xs, out_hw, k, b)
    assert t_resize.CONV_F32_KERNEL.launches == before + 1
    assert t_resize.CONV_KERNEL.launches == before16
    _check_head(out, xs, out_hw, k, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("O", [32, 48, 64, 80, 112])
def test_resize_conv_relu_kernel_widths(card, dtype, O):
    """K8 in both dtypes at every padded product width (O rounded up to 32,
    48, 64, 96 or 128), C not a multiple of the 32-channel bf16 chunk."""
    g = torch.Generator().manual_seed(O + 3)
    xs, k, b = _head_args(g, [(6, 10), (3, 5)], 80, O, dtype)
    _check_head(t_resize.resize_sum_conv_relu(xs, (21, 35), k, b), xs, (21, 35), k, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_conv_relu_kernel_takes_larger_inputs(card, dtype):
    """K8 with inputs larger than the output (a tile's taps reach past the
    bf16 producers' staged patch, which then read device memory) beside one
    the patch holds."""
    g = torch.Generator().manual_seed(5)
    xs, k, b = _head_args(g, [(40, 70), (7, 9)], 64, 32, dtype)
    _check_head(t_resize.resize_sum_conv_relu(xs, (21, 35), k, b), xs, (21, 35), k, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shapes,out_hw,C,O", [
    (HEAD_PATH, (112, 192), 768, 96), ([(5, 7), (11, 3)], (37, 29), 32, 16),
    ([(3, 4)], (9, 50), 48, 128), ([(4, 3), (8, 6), (16, 12), (32, 24)], (64, 48), 768, 96),
    ([(2, 3), (4, 6), (8, 12), (16, 24)], (32, 48), 96, 96),
    ([(20, 30), (7, 11), (3, 5)], (7, 11), 24, 8), ([(1, 1)], (1, 1), 16, 8),
    ([(2, 900), (5, 3)], (5, 600), 40, 40)])
def test_resize_phase_head_kernel(card, dtype, shapes, out_hw, C, O):
    """K9 (with its u_i = x_i K' matmul) against resize_sum_conv_relu_lowres
    at the head's shapes, the small models' heads and the plan test's
    ragged sizes."""
    g = torch.Generator().manual_seed(C + O + 1)
    xs, k, b = _head_args(g, shapes, C, O, dtype)
    before = t_resize.PHASE_KERNEL.launches
    out = t_resize.resize_sum_conv_relu_phase(xs, out_hw, k, b)
    assert t_resize.PHASE_KERNEL.launches == before + 1
    _check(out, t_resize.resize_sum_conv_relu_lowres(xs, out_hw, k, b), dtype)


@pytest.mark.parametrize("dtype,O", [(torch.bfloat16, 8), (torch.bfloat16, 16),
                                     (torch.bfloat16, 96), (torch.bfloat16, 128),
                                     (torch.float32, 4), (torch.float32, 52)])
def test_resize_phase_head_kernel_widths(card, dtype, O):
    """K9 at every O chunk width the plan takes (O below, at and above the
    32-channel chunk, a ragged last chunk) and f32's 4-channel groups."""
    g = torch.Generator().manual_seed(O + 21)
    xs, k, b = _head_args(g, [(6, 10), (3, 5), (12, 20)], 80, O, dtype)
    _check(t_resize.resize_sum_conv_relu_phase(xs, (24, 40), k, b),
           t_resize.resize_sum_conv_relu_lowres(xs, (24, 40), k, b), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_phase_head_kernel_takes_larger_inputs(card, dtype):
    """K9 with tasks larger than the output beside smaller ones, and one far
    wider than the output."""
    g = torch.Generator().manual_seed(22)
    for shapes, out_hw in (([(40, 70), (7, 9)], (21, 35)), ([(3, 2000)], (4, 50))):
        xs, k, b = _head_args(g, shapes, 64, 32, dtype)
        _check(t_resize.resize_sum_conv_relu_phase(xs, out_hw, k, b),
               t_resize.resize_sum_conv_relu_lowres(xs, out_hw, k, b), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resize_phase_head_kernel_is_deterministic(card, dtype):
    """Two launches at the head's shape give the same bits (the products and
    the kernel: no atomics, no split sums)."""
    g = torch.Generator().manual_seed(23)
    xs, k, b = _head_args(g, HEAD_PATH, 768, 96, dtype)
    a = t_resize.resize_sum_conv_relu_phase(xs, (112, 192), k, b)
    c = t_resize.resize_sum_conv_relu_phase(xs, (112, 192), k, b)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


def test_eval_only_kernels_raise_under_grad(card):
    """K7, K8 and K9 have no backward: under grad they raise rather than
    return a result with no grad_fn."""
    g = torch.Generator().manual_seed(8)
    q = _randn(g, 1, 16, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="eval-only"):
        t_attn.cvt_cross_attention(q, _randn(g, 1, 4, 64), _randn(g, 1, 4, 64), 2, 0.125)
    xs, k, b = _head_args(g, [(3, 4)], 32, 16)
    xs[0].requires_grad_()
    for head in (t_resize.resize_sum_conv_relu, t_resize.resize_sum_conv_relu_phase):
        with pytest.raises(RuntimeError, match="eval-only"):
            head(xs, (6, 8), k, b)


def test_new_kernels_refuse_what_they_do_not_take(card):
    g = torch.Generator().manual_seed(9)
    with pytest.raises(ValueError):  # K7 takes bf16 and f32 (its f32 instance), not f16
        t_attn.cvt_cross_attention(*(_randn(g, 1, n, 64, dtype=torch.float16)
                                     for n in (8, 2, 2)), 2, 0.125)
    with pytest.raises(K.KernelLaunchError):  # K7: more keys than the TPU kernel takes
        t_attn.cvt_cross_attention(_randn(g, 1, 8, 64), _randn(g, 1, 129, 64),
                                   _randn(g, 1, 129, 64), 2, 0.125)
    with pytest.raises(K.KernelLaunchError):  # K7: k and v beyond one CTA's shared memory
        t_attn.cvt_cross_attention(_randn(g, 1, 8, 768), _randn(g, 1, 128, 768),
                                   _randn(g, 1, 128, 768), 2, 0.125)
    with pytest.raises(K.KernelLaunchError):  # K7: head_dim not a multiple of 16
        t_attn.cvt_cross_attention(*(_randn(g, 1, n, 72) for n in (8, 2, 2)), 3, 0.125)
    xs, k, b = _head_args(g, [(3, 4)], 32, 16, torch.float16)
    with pytest.raises(ValueError):  # K8 takes bf16 and f32 (its f32 instance), not f16
        t_resize.resize_sum_conv_relu(xs, (6, 8), k, b)
    xs, k, b = _head_args(g, [(3, 4)], 40, 16)
    with pytest.raises(ValueError):  # K8: C not a multiple of 16
        t_resize.resize_sum_conv_relu(xs, (6, 8), k, b)
    with pytest.raises(ValueError):  # K11: temporal stride 1 only
        t_pool.depthwise_pool3d(_randn(g, 1, 4, 5, 5, 16), _randn(g, 3, 3, 3, 16,
                                                               dtype=torch.float32), (2, 1, 1))
    with pytest.raises(ValueError):  # K11: channels not in 16-byte groups
        t_pool.depthwise_pool3d(_randn(g, 1, 4, 5, 5, 12), _randn(g, 3, 3, 3, 12,
                                                               dtype=torch.float32), (1, 1, 1))


# ------------------------------------------------------------- K10, K12 ---


def _k12_args(g, BH, Lq, k_shape, D=96):
    """q, k, v (BH, L, D) bf16 with cls at row 0, the f32 bias terms with
    a zero cls row, as MViT's token-concat layout hands them to K12."""
    Lk = 1 + k_shape[0] * k_shape[1] * k_shape[2]
    q, k, v = (_randn(g, BH, n, D) for n in (Lq, Lk, Lk))
    rels = []
    for n in k_shape:
        r = _randn(g, BH, Lq, n, dtype=torch.float32, scale=0.5)
        r[:, 0] = 0
        rels.append(r)
    return q, k, v, rels


# MViT-small's K12 shapes at B=2, Lq cut down: block 0 (1 head, Lk 673, Lq
# ragged against the 64-row tiles), block 1 (2 heads, Lk 2689), block 14 (8
# heads, Lq = Lk - 2016 = 673 against Lk 2689)
K12_SHAPES = [(2, 1001, (8, 7, 12)), (4, 701, (8, 14, 24)), (16, 673, (8, 14, 24))]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("BH,Lq,k_shape", K12_SHAPES)
def test_fused_bias_attention_kernel(card, BH, Lq, k_shape, residual):
    g = torch.Generator().manual_seed(Lq + BH)
    q, k, v, rels = _k12_args(g, BH, Lq, k_shape)
    before = t_attn.CLS_KERNEL.launches
    out = t_attn.fused_bias_attention_fwd(q, k, v, *rels, k_shape, 96 ** -0.5, residual)
    assert t_attn.CLS_KERNEL.launches == before + 1
    ref = t_attn.fused_bias_attention_plain(q, k, v, *rels, k_shape, 96 ** -0.5, residual)
    _check(out, ref, torch.bfloat16)
    _check(out[:, 0], ref[:, 0], torch.bfloat16)  # the cls row: no residual


@pytest.mark.parametrize("D", [64, 128])
def test_fused_bias_attention_kernel_head_dims(card, D):
    g = torch.Generator().manual_seed(D)
    q, k, v, rels = _k12_args(g, 2, 300, (2, 3, 4), D)
    _check(t_attn.fused_bias_attention_fwd(q, k, v, *rels, (2, 3, 4), D ** -0.5, True),
           t_attn.fused_bias_attention_plain(q, k, v, *rels, (2, 3, 4), D ** -0.5, True),
           torch.bfloat16)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("BH,Lq,k_shape", K12_SHAPES)
def test_fused_bias_attention_bwd_kernel(card, BH, Lq, k_shape, residual):
    g = torch.Generator().manual_seed(Lq + BH + 1)
    q, k, v, rels = _k12_args(g, BH, Lq, k_shape)
    go = _randn(g, *q.shape)
    args = (q, k, v, *rels, go, k_shape, 96 ** -0.5, residual)
    lse = t_attn.fused_bias_attention_fwd(q, k, v, *rels, k_shape, 96 ** -0.5, residual,
                                          return_lse=True)[1]
    before = t_attn.CLS_BWD_KERNEL.launches
    got = t_attn.fused_bias_attention_bwd(*args, lse=lse)
    assert t_attn.CLS_BWD_KERNEL.launches == before + 1
    ref = t_attn.fused_bias_attention_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "drel_t", "drel_h", "drel_w"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close_bf16(a, b)


@pytest.mark.parametrize("acc_dt,x_dt", [(torch.bfloat16, torch.bfloat16),
                                         (torch.float32, torch.float32),
                                         (torch.bfloat16, torch.float32),
                                         (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape,out_hw,C", [((7, 12), (112, 192), 768), ((56, 96), (112, 192), 96),
                                            ((5, 3), (9, 17), 8), ((20, 30), (7, 11), 24)])
def test_resize_add_kernel(card, acc_dt, x_dt, shape, out_hw, C):
    """K10 at the decoder sum's shapes (the coarsest and the finest task
    map, B=2) and at ragged up- and down-sampling sizes, every dtype pair,
    against the plain version; acc is left as it was."""
    g = torch.Generator().manual_seed(C + shape[0])
    acc = _randn(g, 2, *out_hw, C, dtype=acc_dt)
    x = _randn(g, 2, *shape, C, dtype=x_dt)
    acc0 = acc.clone()
    before = t_resize.ADD_KERNEL.launches
    out = t_resize.bilinear_resize_add(acc, x)
    assert t_resize.ADD_KERNEL.launches == before + 1 and out.dtype == acc_dt
    _check(out, t_resize.bilinear_resize_add_plain(acc, x), acc_dt)
    assert torch.equal(acc, acc0)


def test_resize_add_kernel_sums_like_k4(card):
    """K10 four times from a zero accumulator gives K4's sum of the same
    four maps up to bf16 rounding of the running sum: five roundings of
    partial sums, each within half a bf16 ulp (2^-8 relative) of the sum
    of the terms' magnitudes."""
    g = torch.Generator().manual_seed(11)
    xs = [_randn(g, 2, h, w, 64) for h, w in HEAD_PATH]
    acc = torch.zeros(2, 112, 192, 64, dtype=torch.bfloat16, device="cuda")
    for x in xs:
        acc = t_resize.bilinear_resize_add(acc, x)
    ref = t_resize.bilinear_resize_sum(xs, (112, 192)).float()
    mag = t_resize.bilinear_resize_sum_plain([x.float().abs() for x in xs], (112, 192))
    torch.cuda.synchronize()
    assert bool(((acc.float() - ref).abs() <= 1e-2 + 5 * 2.0**-8 * mag).all())


def test_k10_k12_record_a_backward_or_raise(card):
    """On CUDA tensors that require grad, K12 and K10 return a result with
    a grad_fn: K12's backward runs its backward kernel and reaches q, k, v
    and the three bias terms; K10's is the plain resize backward. Inputs
    the kernels do not take raise."""
    g = torch.Generator().manual_seed(12)
    q, k, v, rels = _k12_args(g, 2, 70, (1, 3, 4), 64)
    ins = [t.requires_grad_() for t in (q, k, v, *rels)]
    out = t_attn.fused_bias_attention(*ins, (1, 3, 4), 0.125, True)
    acc, x = _randn(g, 1, 6, 8, 16).requires_grad_(), _randn(g, 1, 3, 4, 16).requires_grad_()
    out2 = t_resize.bilinear_resize_add(acc, x)
    assert out.grad_fn is not None and out2.grad_fn is not None
    K.reset_launch_counts()
    (out.float().sum() + out2.float().sum()).backward()
    assert K.launch_counts()["fused_bias_attention_bwd"] == 1
    for t in ins + [acc, x]:
        assert t.grad is not None and t.grad.dtype == t.dtype and bool(torch.isfinite(t.grad).all())
    with pytest.raises(ValueError):  # K12 takes q, k, v of one dtype
        t_attn.fused_bias_attention_fwd(q.detach().float(), k.detach(), v.detach(),
                                        *(r.detach() for r in rels), (1, 3, 4), 0.125)
    with pytest.raises(ValueError):  # and f32 bias terms
        t_attn.fused_bias_attention_fwd(q.detach(), k.detach(), v.detach(),
                                        *(r.detach().bfloat16() for r in rels), (1, 3, 4), 0.125)
    with pytest.raises(ValueError):  # K10: channels in groups of 8
        t_resize.bilinear_resize_add(_randn(g, 1, 6, 8, 12), _randn(g, 1, 3, 4, 12))


def test_a_kernel_that_does_not_build_fails_loudly(card, monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text('extern "C" int dsal_broken() { return undefined_name; }\n')
    monkeypatch.setattr(K, "CSRC_DIR", src)
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    kern = K.Kernel("broken", "broken.cu", "dsal_broken", [], replaces="")
    with pytest.raises(K.KernelBuildError, match="undefined_name"):
        kern.launch()
    assert kern.launches == 0 and not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("cls_stream", [False, True])
def test_tiny_mvit_launches_follow_the_layout(card, cls_stream):
    """A tiny MViT in bf16 with pool_mode="pallas": under cls_stream=False
    every block's attention launches K12 forward and backward and no pool
    runs K11 (JAX pools by convolution there); under cls_stream=True K1,
    K5 and K11. K2 launches 7 per block plus one per emitted scale in both."""
    from diff_sal_tpu_torch.config import MViTConfig
    from diff_sal_tpu_torch.models.diff_model import init_weights
    from diff_sal_tpu_torch.models.mvit import MViT

    cfg = MViTConfig.tiny(spatial_size=(64, 96), cls_stream=cls_stream, pool_mode="pallas")
    m = init_weights(MViT(cfg), 13).to(card)
    x = torch.randn(2, 16, 64, 96, 3, generator=torch.Generator().manual_seed(14)).to(card)
    K.reset_launch_counts()
    outs = m(x, torch.bfloat16)
    fwd = K.launch_counts()
    sum(o.float().sum() for o in outs).backward()
    bwd = {n: c - fwd[n] for n, c in K.launch_counts().items()}
    L = cfg.num_layers
    new, old = (("bias_attention", "fused_bias_attention") if cls_stream
                else ("fused_bias_attention", "bias_attention"))
    assert fwd[new] == L and fwd[old] == 0, fwd
    assert bwd[new + "_bwd"] == L and bwd[old + "_bwd"] == 0, bwd
    assert fwd["layer_norm"] == 7 * L + len(cfg.out_scales), fwd
    assert (fwd["depthwise_pool3d"] > 0) == cls_stream, fwd
    assert all(torch.isfinite(o.float()).all() for o in outs)


# ------------------------------- the attention backward (wgmma, TMA) -------


def _bwd_case(layout, H, Lq, k_shape, seed, dtype=torch.bfloat16, B=2):
    """Inputs, the plain and the kernel backward of K5 (cls stream) or K12
    (token concat, B*H batches of one head, the cls row at row 0)."""
    g = torch.Generator().manual_seed(seed)
    scale = 96 ** -0.5
    if layout == "k1":
        Lk = 1 + k_shape[0] * k_shape[1] * k_shape[2]
        q, k, v, go = (_randn(g, B, n, H * 96, dtype=dtype) for n in (Lq, Lk, Lk, Lq))
        rel = _randn(g, B, Lq, H, sum(k_shape), dtype=dtype, scale=0.5)
        ins = (q, k, v, rel)
        fwd, bwd, plain = t_attn.bias_attention_fwd, t_attn.bias_attention_bwd, \
            t_attn.bias_attention_bwd_plain
        extra = (k_shape, H, scale)
    else:
        q, k, v, rels = _k12_args(g, B * H, Lq + 1, k_shape)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        go = _randn(g, *q.shape, dtype=dtype)
        ins = (q, k, v, *rels)
        fwd, bwd, plain = t_attn.fused_bias_attention_fwd, t_attn.fused_bias_attention_bwd, \
            t_attn.fused_bias_attention_bwd_plain
        extra = (k_shape, scale)
    return ins, go, extra, fwd, bwd, plain


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape", MVIT_BLOCKS)
def test_attention_bwd_kernel_block_shapes(card, H, Lq, k_shape, layout, residual):
    """K5 and K12's backward at every MViT block shape (B=2, full Lq: Lq a
    multiple of 64 for K5 and one more for K12; Lk = 673 ends in a 33-key
    tile), against their plain versions, with the forward kernel's
    logsumexp."""
    ins, go, extra, fwd, bwd, plain = _bwd_case(layout, H, Lq, k_shape, Lq + H)
    lse = fwd(*ins, *extra, residual, return_lse=True)[1]
    kern = t_attn.BWD_KERNEL if layout == "k1" else t_attn.CLS_BWD_KERNEL
    before = kern.launches
    got = bwd(*ins, go, *extra, residual, lse=lse)
    assert kern.launches == before + 1
    ref = plain(*ins, go, *extra, residual)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        _close_bf16(a, b)


@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape", [(1, 43008, (8, 7, 12)), (2, 10752, (8, 14, 24))])
def test_attention_bwd_kernel_is_deterministic(card, H, Lq, k_shape, layout):
    """No atomics: two runs on the same inputs give the same bits."""
    ins, go, extra, fwd, bwd, _ = _bwd_case(layout, H, Lq, k_shape, 5)
    lse = fwd(*ins, *extra, True, return_lse=True)[1]
    a = bwd(*ins, go, *extra, True, lse=lse)
    b = bwd(*ins, go, *extra, True, lse=lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_forward_lse_matches_the_plain_logsumexp(card):
    """The forward kernel's saved logsumexp against the plain scores', in
    both layouts (f32; ex2.approx in the kernel)."""
    g = torch.Generator().manual_seed(21)
    q, k, v = (_randn(g, 2, n, 192) for n in (1000, 673, 673))
    rel = _randn(g, 2, 1000, 2, 27, scale=0.5)
    _, lse = t_attn.bias_attention_fwd(q, k, v, rel, (8, 7, 12), 2, 96 ** -0.5, return_lse=True)
    _, ref = t_attn.bias_attention_plain(q, k, v, rel, (8, 7, 12), 2, 96 ** -0.5,
                                         return_lse=True)
    torch.testing.assert_close(lse, ref, atol=1e-4, rtol=1e-5)
    q, k, v, rels = _k12_args(g, 4, 701, (8, 14, 24))
    _, lse = t_attn.fused_bias_attention_fwd(q, k, v, *rels, (8, 14, 24), 96 ** -0.5,
                                             return_lse=True)
    _, ref = t_attn.fused_bias_attention_plain(q, k, v, *rels, (8, 14, 24), 96 ** -0.5,
                                               return_lse=True)
    torch.testing.assert_close(lse, ref, atol=1e-4, rtol=1e-5)


# ------------------------------------------------------ the f32 instances ---


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape", [(1, 1000, (8, 7, 12)), (2, 333, (8, 14, 24)),
                                          (8, 96, (2, 3, 4))])
def test_attention_f32_kernels(card, H, Lq, k_shape, layout, residual):
    """The f32 instances of K1 / K12 forward and of their backward against
    the plain versions at f32 (1e-5), at MViT's key grids with Lq ragged
    against the 32-row tiles, and a small grid with eight heads."""
    ins, go, extra, fwd, bwd, plain = _bwd_case(layout, H, Lq, k_shape, Lq, torch.float32)
    plain_fwd = t_attn.bias_attention_plain if layout == "k1" else t_attn.fused_bias_attention_plain
    kerns = ((t_attn.F32_KERNEL, t_attn.F32_BWD_KERNEL) if layout == "k1"
             else (t_attn.CLS_F32_KERNEL, t_attn.CLS_F32_BWD_KERNEL))
    before = [k.launches for k in kerns]
    out, lse = fwd(*ins, *extra, residual, return_lse=True)
    ref_out, ref_lse = plain_fwd(*ins, *extra, residual, return_lse=True)
    _check(out, ref_out, torch.float32)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-6)
    got = bwd(*ins, go, *extra, residual, lse=lse)
    assert [k.launches for k in kerns] == [n + 1 for n in before]
    for i, (a, b) in enumerate(zip(got, plain(*ins, go, *extra, residual))):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, i
        _check(a, b, torch.float32)


@pytest.mark.parametrize("C,R", [(768, 840), (384, 337), (192, 1000), (96, 50)])
def test_block_tail_f32_kernel(card, C, R):
    """K3's f32 instance at the decoder's four widths (R ragged against
    the 16-row CTA)."""
    g = torch.Generator().manual_seed(C + R)
    f = torch.float32
    Hd = 2 * C
    skip, attn = _randn(g, R, C, dtype=f), _randn(g, R, C, dtype=f)
    lw, lb = _randn(g, C, dtype=f) + 1, _randn(g, C, dtype=f, scale=0.1)
    w1, b1 = _randn(g, Hd, C, dtype=f, scale=C ** -0.5), _randn(g, Hd, dtype=f, scale=0.1)
    w2, b2 = _randn(g, C, Hd, dtype=f, scale=Hd ** -0.5), _randn(g, C, dtype=f, scale=0.1)
    args = (skip, attn, lw, lb, w1, b1, w2, b2, 1e-6, "tanh")
    before = t_mlp.F32_KERNEL.launches
    out = t_mlp.block_tail(*args)
    assert t_mlp.F32_KERNEL.launches == before + 1
    _check(out, t_mlp.block_tail_plain(*args), f)


def _tail_f32_args(g, R, C, act):
    f = torch.float32
    Hd = 2 * C
    skip, attn = _randn(g, R, C, dtype=f), _randn(g, R, C, dtype=f)
    lw, lb = _randn(g, C, dtype=f) + 1, _randn(g, C, dtype=f, scale=0.1)
    w1, b1 = _randn(g, Hd, C, dtype=f, scale=C ** -0.5), _randn(g, Hd, dtype=f, scale=0.1)
    w2, b2 = _randn(g, C, Hd, dtype=f, scale=Hd ** -0.5), _randn(g, C, dtype=f, scale=0.1)
    return (skip, attn, lw, lb, w1, b1, w2, b2, 1e-6, act)


# the decoder's four calls at full width, B = 2 (a DDIM run's rows), and
# phase 10's small model's rows
TAIL_F32_SHAPES = [(768, 840), (384, 3360), (192, 13440), (96, 53760), (768, 30), (384, 120),
                   (192, 480), (96, 1920)]


@pytest.mark.parametrize("C,R", TAIL_F32_SHAPES)
@pytest.mark.parametrize("act", ["tanh", "exact"])
def test_block_tail_f32_kernel_decoder_shapes(card, C, R, act):
    """K3's f32 instance (split TF32) at the decoder's four calls at full
    width and at phase 10's rows, both GELUs: one launch (with its split
    reduction where the plan splits the hidden axis), within 1e-5 of the
    plain version in f32, and no further from the plain version in f64
    than max(1e-5, twice the f32 plain version's own distance)."""
    g = torch.Generator().manual_seed(5 * C + R)
    args = _tail_f32_args(g, R, C, act)
    before = t_mlp.F32_KERNEL.launches
    out = t_mlp.block_tail(*args)
    assert t_mlp.F32_KERNEL.launches == before + 1
    plain = t_mlp.block_tail_plain(*args)
    _check(out, plain, torch.float32)
    ref = t_mlp.block_tail_plain(*(a.double() if isinstance(a, torch.Tensor) else a
                                   for a in args))
    own = float((plain.double() - ref).abs().max())
    assert float((out.double() - ref).abs().max()) <= max(1e-5, 2 * own)


def test_block_tail_f32_shapes_take_every_plan(card):
    """The shapes above launch one and two column splits, hidden chunks of
    64 and 128, with and without the hidden split."""
    plans = [t_mlp.tail_f32_plan(R, C, 2 * C) for C, R in TAIL_F32_SHAPES]
    assert {p.col_splits for p in plans} == {1, 2}
    assert {p.hc for p in plans} == {64, 128}
    assert {p.k_splits > 1 for p in plans} == {False, True}


@pytest.mark.parametrize("C,R", [(768, 840), (768, 30), (96, 53760)])
def test_block_tail_f32_kernel_is_deterministic(card, C, R):
    """Two launches give the same bits (the hidden splits' partial sums in a
    fixed order)."""
    g = torch.Generator().manual_seed(C + 2 * R)
    args = _tail_f32_args(g, R, C, "exact")
    a = t_mlp.block_tail(*args)
    b = t_mlp.block_tail(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_block_tail_f32_refuses_grad(card):
    """K3 (both instances) is eval-only: with grad on and an input that
    requires grad it raises instead of returning a result with no
    gradient."""
    g = torch.Generator().manual_seed(9)
    args = list(_tail_f32_args(g, 64, 96, "tanh"))
    args[4] = args[4].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="eval-only"):
        t_mlp.block_tail(*args)
    with torch.no_grad():
        t_mlp.block_tail(*args)


@pytest.mark.parametrize("L,S,C,heads", [(84, 18, 768, 2), (5376, 18, 96, 2), (77, 128, 96, 3),
                                         (130, 33, 64, 2)])
def test_cvt_attention_f32_kernel(card, L, S, C, heads):
    """K7's f32 instance at the decoder's coarsest and finest stage and at
    ragged sizes (128 keys, three heads)."""
    g = torch.Generator().manual_seed(L + S)
    f = torch.float32
    q, k, v = _randn(g, 2, L, C, dtype=f), _randn(g, 2, S, C, dtype=f), _randn(g, 2, S, C, dtype=f)
    before = t_attn.CVT_F32_KERNEL.launches
    out = t_attn.cvt_cross_attention(q, k, v, heads, C ** -0.5)
    assert t_attn.CVT_F32_KERNEL.launches == before + 1
    _check(out, t_attn.reference_cvt_attention(q, k, v, heads, C ** -0.5), f)


@pytest.mark.parametrize("cls_stream", [True, False])
def test_small_av_model_f32_on_card_matches_cpu(card, cls_stream):
    """The whole port in f32 (both packages' default) at the small AV size,
    in both MViT layouts: through the kernels' f32 instances on the card
    against the plain versions on the CPU, same weights and noise. The map
    within 1e-4 (PERF.md's per-network f32 tolerance), and one training
    step's gradients within 1e-2 relative L2 per tensor (two f32
    implementations at random weights differ by ~1e-3, PERF.md)."""
    from diff_sal_tpu_torch.config import (AudioAttnConfig, DataTransformConfig,
                                           ExperimentConfig, ModelConfig, MViTConfig,
                                           SalUNetConfig, SamplingConfig, VGGishConfig)
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    hw = (128, 96)
    cfg = ModelConfig(visual=MViTConfig.tiny(spatial_size=hw, cls_stream=cls_stream),
                      audio=VGGishConfig(), spatiotemp=AudioAttnConfig(),
                      decoder=SalUNetConfig(img_size=hw, dropout=0.0, drop_path_rate=(0.0,) * 4))
    g = torch.Generator().manual_seed(7)
    rgb, audio = torch.randn(2, 16, *hw, 3, generator=g), torch.randn(2, 9, 64, 48, 1, generator=g)
    noise = torch.randn(2, *hw, 1, generator=g)
    args = (make_schedule(), SamplingConfig(), DataTransformConfig())
    cpu = build_model(cfg, 8, device="cpu")
    ref = sample_saliency(cpu, *args, rgb, audio, noise=noise)
    gpu = VideoSaliencyModel(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(card)
    K.reset_launch_counts()
    out = sample_saliency(gpu, *args, rgb.to(card), audio.to(card), noise=noise)
    counts = K.launch_counts()
    attn = "bias_attention_f32" if cls_stream else "fused_bias_attention_f32"
    assert counts[attn] > 0 and counts["block_tail_f32"] > 0, counts
    assert counts["bias_attention"] == counts["fused_bias_attention"] == 0, counts
    assert float((out.cpu() - ref).abs().max()) <= 1e-4

    sd = cpu.state_dict()
    batch = {"rgb": rgb, "salmap": torch.rand(2, *hw, 1, generator=g), "audio": audio}
    draws = {"deq": torch.randn(2, *hw, 1, generator=g), "noise": torch.randn(2, *hw, 1, generator=g),
             "t": torch.tensor(300)}

    def step(device):
        m = VideoSaliencyModel(cfg).train()
        m.load_state_dict(sd)
        m.to(device)
        ecfg = ExperimentConfig(model=cfg)
        met = make_train_step(m, make_schedule(), ecfg)(make_optimizer(m, ecfg.optim, 10, 2),
                                                         batch, draws=draws)
        return float(met["total"]), {n: p.grad.cpu() for n, p in m.named_parameters()
                                     if p.grad is not None}

    l_cpu, g_cpu = step("cpu")
    K.reset_launch_counts()
    l_card, g_card = step(card)
    assert K.launch_counts()[attn.replace("_f32", "_bwd_f32")] > 0
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    assert set(g_card) == set(g_cpu)
    top = max(float(t.abs().max()) for t in g_cpu.values())
    for n, ref_g in g_cpu.items():
        if float(ref_g.abs().max()) > 1e-6 * top:
            assert float((g_card[n] - ref_g).norm() / ref_g.norm()) <= 1e-2, n


# -------------------------- the f32 forward on the tensor cores (split TF32) ---


def _f32_fwd_case(layout, H, Lq, k_shape, D, seed):
    """f32 inputs of K1 (B=2 batches of H heads) or K12 (2H batches of one
    head, the cls row at row 0 of q and a zero cls bias row), the forward
    wrapper, its plain version, the kernel record and the trailing args."""
    g = torch.Generator().manual_seed(seed)
    f = torch.float32
    Lk = 1 + k_shape[0] * k_shape[1] * k_shape[2]
    scale = D ** -0.5
    if layout == "k1":
        q, k, v = (_randn(g, 2, n, H * D, dtype=f) for n in (Lq, Lk, Lk))
        ins = (q, k, v, _randn(g, 2, Lq, H, sum(k_shape), dtype=f, scale=0.5))
        return (ins, (k_shape, H, scale), t_attn.bias_attention_fwd,
                t_attn.bias_attention_plain, t_attn.F32_KERNEL)
    q, k, v, rels = _k12_args(g, 2 * H, Lq + 1, k_shape, D)
    ins = tuple(t.float() for t in (q, k, v)) + tuple(rels)
    return (ins, (k_shape, scale), t_attn.fused_bias_attention_fwd,
            t_attn.fused_bias_attention_plain, t_attn.CLS_F32_KERNEL)


# (H, Lq, key grid, head_dim): Lq and Lk ragged against the 64-row and
# 64-key tiles (Lk = 673, 211, 2843), the most bias bins (kt+kh+kw = 128),
# every head_dim, grids small enough for 64-row CTAs (their keys split over
# a cluster) and large enough for 128, and 128 rows with 128 bins, which
# take 32-key tiles
F32_FWD_SHAPES = [(2, 1000, (8, 7, 12), 96), (1, 333, (5, 6, 7), 64), (4, 130, (98, 1, 29), 96),
                  (2, 777, (5, 6, 7), 128), (8, 2000, (8, 7, 12), 96),
                  (8, 1500, (98, 1, 29), 96)]


def test_f32_forward_shapes_take_every_plan():
    """The shapes above reach 64 and 128 rows per CTA, 64- and 32-key tiles,
    and keys split over a cluster with either tile (the plan, on the CPU)."""
    plans = {(p.rows, p.block_n, p.splits > 1) for p in (
        t_attn.f32_fwd_plan(2, H, Lq, 1 + ks[0] * ks[1] * ks[2], D, ks)
        for H, Lq, ks, D in F32_FWD_SHAPES)}
    assert {(64, 64, True), (64, 32, True), (128, 64, False), (128, 32, False)} <= plans


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape,D", F32_FWD_SHAPES)
def test_f32_attention_forward_kernel(card, H, Lq, k_shape, D, layout, residual):
    """K1 and K12 forward in f32 (split TF32 on the tensor cores) against
    their plain versions at f32: the output within 1e-5 and each row's
    logsumexp within 1e-5 (+1e-6 relative), one launch."""
    ins, extra, fwd, plain, kern = _f32_fwd_case(layout, H, Lq, k_shape, D, Lq + D)
    before = kern.launches
    out, lse = fwd(*ins, *extra, residual, return_lse=True)
    assert kern.launches == before + 1
    ref, ref_lse = plain(*ins, *extra, residual, return_lse=True)
    _check(out, ref, torch.float32)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape", MVIT_BLOCKS)
def test_f32_attention_forward_block_shapes(card, H, Lq, k_shape, layout):
    """The f32 forward at MViTv2-small's seven block shapes (B=2, full Lq,
    head_dim 96) against the plain version at f32, with the residual."""
    ins, extra, fwd, plain, _ = _f32_fwd_case(layout, H, Lq, k_shape, 96, H)
    out, lse = fwd(*ins, *extra, True, return_lse=True)
    ref, ref_lse = plain(*ins, *extra, True, return_lse=True)
    _check(out, ref, torch.float32)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("layout", ["k1", "k12"])
def test_f32_attention_forward_is_deterministic(card, layout):
    """Fixed order of every sum: two runs give the same bits."""
    ins, extra, fwd, _, _ = _f32_fwd_case(layout, 2, 10752, (8, 14, 24), 96, 3)
    a = fwd(*ins, *extra, True, return_lse=True)
    b = fwd(*ins, *extra, True, return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------- K7, the streaming kernel ---


@pytest.mark.parametrize("S", [1, 18, 128])
@pytest.mark.parametrize("hd", [48, 96, 192, 384])
def test_cvt_attention_kernel_head_dims_and_keys(card, hd, S):
    """K7 at the decoder's head_dims (two heads) with one key, the shipped
    18 and the most the TPU kernel takes, L ragged against the 64-row
    tiles; head_dim 384 at 128 keys does not fit one CTA and is refused
    (test_new_kernels_refuse_what_they_do_not_take)."""
    if hd == 384 and S == 128:
        with pytest.raises(ValueError, match="shared memory"):
            t_attn.cvt_plan(3, 201, S, 2 * hd, 2)
        return
    g = torch.Generator().manual_seed(hd + S)
    C = 2 * hd
    q, k, v = _randn(g, 3, 201, C), _randn(g, 3, S, C), _randn(g, 3, S, C)
    before = t_attn.CVT_KERNEL.launches
    out = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    assert t_attn.CVT_KERNEL.launches == before + 1
    _check(out, t_attn.reference_cvt_attention(q, k, v, 2, C ** -0.5), torch.bfloat16)


@pytest.mark.parametrize("Bt,L,S,C", [(64, 330, 18, 96), (8, 700, 64, 768), (10, 5376, 18, 96)])
def test_cvt_attention_kernel_walks_across_batch_items(card, Bt, L, S, C):
    """More tiles than CTAs, so a CTA's walk crosses from one batch item
    (and head group) to the next and reloads k and v: each batch item gets
    its own keys (a stale k or v would show), and two runs give the same
    bits."""
    plan = t_attn.cvt_plan(Bt, L, S, C, 2)
    crossing = [c for c in range(plan.ctas)
                if (c * plan.tiles // plan.ctas) // plan.row_tiles
                != ((c + 1) * plan.tiles // plan.ctas - 1) // plan.row_tiles]
    assert plan.tiles > plan.ctas and crossing
    g = torch.Generator().manual_seed(Bt + L)
    q, k, v = _randn(g, Bt, L, C), _randn(g, Bt, S, C), _randn(g, Bt, S, C)
    out = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    _check(out, t_attn.reference_cvt_attention(q, k, v, 2, C ** -0.5), torch.bfloat16)
    again = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


# ------------------------- the f32 backward on the tensor cores (split TF32) ---


def _f32_bwd_case(layout, H, Lq, k_shape, D, seed, B=2):
    """f32 inputs of K5 (B batches of H heads) or K12's backward (B*H
    batches of one head, the cls row at row 0), an output gradient, the
    forward and backward wrappers, the plain backward, the backward
    kernel's record and the trailing args."""
    g = torch.Generator().manual_seed(seed)
    f = torch.float32
    Lk = 1 + k_shape[0] * k_shape[1] * k_shape[2]
    scale = D ** -0.5
    if layout == "k1":
        q, k, v = (_randn(g, B, n, H * D, dtype=f) for n in (Lq, Lk, Lk))
        ins = (q, k, v, _randn(g, B, Lq, H, sum(k_shape), dtype=f, scale=0.5))
        return (ins, _randn(g, *q.shape, dtype=f), (k_shape, H, scale), t_attn.bias_attention_fwd,
                t_attn.bias_attention_bwd, t_attn.bias_attention_bwd_plain,
                t_attn.F32_BWD_KERNEL)
    q, k, v, rels = _k12_args(g, B * H, Lq + 1, k_shape, D)
    ins = tuple(t.float() for t in (q, k, v)) + tuple(rels)
    return (ins, _randn(g, *q.shape, dtype=f), (k_shape, scale), t_attn.fused_bias_attention_fwd,
            t_attn.fused_bias_attention_bwd, t_attn.fused_bias_attention_bwd_plain,
            t_attn.CLS_F32_BWD_KERNEL)


# (H, Lq, key grid, head_dim) at B = 2: Lq and Lk ragged against the 32-key
# and 16-64-row tiles, every head_dim, the most bias bins (128) and 48,
# q-major CTAs of 64, 32 and 16 rows, k-major grids with and without query
# splits
F32_BWD_SHAPES = [(2, 1000, (8, 7, 12), 96), (1, 333, (5, 6, 7), 64), (4, 130, (98, 1, 29), 96),
                  (2, 777, (5, 6, 7), 128), (8, 2000, (8, 7, 12), 96), (8, 96, (2, 3, 4), 96),
                  (8, 2000, (98, 1, 29), 96), (2, 2000, (8, 14, 24), 96),
                  (2, 4000, (8, 14, 24), 64)]


def test_f32_backward_shapes_take_every_plan():
    """The shapes above reach q-major CTAs of 64, 32 and 16 rows, the three
    drel widths, and k-major grids with and without query splits (the
    plan, on the CPU)."""
    plans = [t_attn.f32_bwd_plan(2, H, Lq, 1 + ks[0] * ks[1] * ks[2], D, ks)
             for H, Lq, ks, D in F32_BWD_SHAPES]
    assert {p.q_rows for p in plans} == {16, 32, 64}
    assert {p.bins for p in plans} == {32, 48, 128}
    assert {p.splits > 1 for p in plans} == {True, False}


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape,D", F32_BWD_SHAPES)
def test_f32_attention_backward_kernel(card, H, Lq, k_shape, D, layout, residual):
    """K5 and K12's backward in f32 (split TF32 on the tensor cores), fed
    with the f32 forward's logsumexp, against their plain versions at f32:
    every output within 1e-5, one launch."""
    ins, go, extra, fwd, bwd, plain, kern = _f32_bwd_case(layout, H, Lq, k_shape, D, Lq + D)
    lse = fwd(*ins, *extra, residual, return_lse=True)[1]
    before = kern.launches
    got = bwd(*ins, go, *extra, residual, lse=lse)
    assert kern.launches == before + 1
    for i, (a, b) in enumerate(zip(got, plain(*ins, go, *extra, residual))):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, i
        _check(a, b, torch.float32)


@pytest.mark.parametrize("layout", ["k1", "k12"])
@pytest.mark.parametrize("H,Lq,k_shape", MVIT_BLOCKS)
def test_f32_attention_backward_block_shapes(card, H, Lq, k_shape, layout):
    """The f32 backward at MViTv2-small's seven block shapes (B=1, full Lq,
    head_dim 96, the residual on) against the plain version computed in
    f64: each output within 1e-5, or within twice the f32 plain version's
    own distance from the f64 result where that is larger (dk and dv sum
    over up to 43008 query rows)."""
    ins, go, extra, fwd, bwd, plain, _ = _f32_bwd_case(layout, H, Lq, k_shape, 96, H, B=1)
    lse = fwd(*ins, *extra, True, return_lse=True)[1]
    got = bwd(*ins, go, *extra, True, lse=lse)
    ref = plain(*(t.double() for t in ins), go.double(), *extra, True)
    own = plain(*ins, go, *extra, True)
    for i, (a, r, o) in enumerate(zip(got, ref, own)):
        limit = max(1e-5, 2 * float((o.double() - r).abs().max()))
        assert float((a.double() - r).abs().max()) <= limit, i


@pytest.mark.parametrize("layout", ["k1", "k12"])
def test_f32_attention_backward_is_deterministic(card, layout):
    """No atomics: two runs on the same inputs give the same bits, with and
    without query splits."""
    for H, Lq, ks in ((2, 10752, (8, 14, 24)), (8, 2000, (98, 1, 29))):
        assert (t_attn.f32_bwd_plan(2, H, Lq, 1 + ks[0] * ks[1] * ks[2], 96, ks).splits > 1) \
            == (H == 2)
        ins, go, extra, fwd, bwd, _, _ = _f32_bwd_case(layout, H, Lq, ks, 96, 3)
        lse = fwd(*ins, *extra, True, return_lse=True)[1]
        a = bwd(*ins, go, *extra, True, lse=lse)
        b = bwd(*ins, go, *extra, True, lse=lse)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------- K7 f32, the streaming kernel ---


@pytest.mark.parametrize("S", [1, 18, 128])
@pytest.mark.parametrize("hd", [32, 48, 96, 192, 384])
def test_cvt_attention_f32_kernel_head_dims_and_keys(card, hd, S):
    """K7's f32 instance at head_dims 32-384 (two heads) with one key, the
    shipped 18 and the most the TPU kernel takes, L ragged against the
    tiles, at the f32 tolerance; head_dim 384 at 128 keys does not fit one
    CTA and is refused."""
    g = torch.Generator().manual_seed(hd + S)
    C, f = 2 * hd, torch.float32
    q, k, v = _randn(g, 3, 201, C, dtype=f), _randn(g, 3, S, C, dtype=f), _randn(g, 3, S, C, dtype=f)
    if hd == 384 and S == 128:
        with pytest.raises(ValueError, match="shared memory"):
            t_attn.cvt_f32_plan(3, 201, S, C, 2)
        with pytest.raises(K.KernelLaunchError):
            t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
        return
    before = t_attn.CVT_F32_KERNEL.launches
    out = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    assert t_attn.CVT_F32_KERNEL.launches == before + 1
    _check(out, t_attn.reference_cvt_attention(q, k, v, 2, C ** -0.5), f)


@pytest.mark.parametrize("S", [1, 18, 128])
@pytest.mark.parametrize("hd,heads", [(8, 4), (24, 2), (24, 4), (24, 8), (40, 2), (40, 3),
                                      (40, 4), (56, 2)])
def test_cvt_attention_f32_kernel_odd_column_groups(card, hd, heads, S):
    """Head_dims with an odd number of 8-column groups: p v ends on a
    single n-tile, which stays within its head. Among them C a multiple of
    32 (the last head ends on the tile's last column) and a group of four
    heads split over two head-ways (24 x 8 heads); every head's output is
    held against the plain version at the f32 tolerance."""
    g = torch.Generator().manual_seed(hd * heads + S)
    C, f = heads * hd, torch.float32
    plan = t_attn.cvt_f32_plan(3, 201, S, C, heads)
    assert (hd, heads) != (24, 8) or (plan.groups, plan.head_ways) == (2, 2), plan
    q, k, v = _randn(g, 3, 201, C, dtype=f), _randn(g, 3, S, C, dtype=f), _randn(g, 3, S, C, dtype=f)
    before = t_attn.CVT_F32_KERNEL.launches
    out = t_attn.cvt_cross_attention(q, k, v, heads, hd ** -0.5)
    assert t_attn.CVT_F32_KERNEL.launches == before + 1
    _check(out, t_attn.reference_cvt_attention(q, k, v, heads, hd ** -0.5), f)


@pytest.mark.parametrize("Bt,L,S,C", [(64, 330, 18, 96), (8, 700, 64, 768), (10, 5376, 18, 96),
                                      (20, 336, 18, 384), (10, 336, 100, 384)])
def test_cvt_attention_f32_kernel_walks_across_batch_items(card, Bt, L, S, C):
    """More tiles than CTAs, so a CTA's walk crosses from one batch item
    (and head group) to the next and reloads k and v: each batch item gets
    its own keys (a stale k or v would show), and two runs give the same
    bits."""
    plan = t_attn.cvt_f32_plan(Bt, L, S, C, 2)
    crossing = [c for c in range(plan.ctas)
                if (c * plan.tiles // plan.ctas) // plan.row_tiles
                != ((c + 1) * plan.tiles // plan.ctas - 1) // plan.row_tiles]
    assert plan.tiles > plan.ctas and crossing
    g = torch.Generator().manual_seed(Bt + L)
    f = torch.float32
    q, k, v = _randn(g, Bt, L, C, dtype=f), _randn(g, Bt, S, C, dtype=f), _randn(g, Bt, S, C, dtype=f)
    out = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    _check(out, t_attn.reference_cvt_attention(q, k, v, 2, C ** -0.5), f)
    again = t_attn.cvt_cross_attention(q, k, v, 2, C ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


# ---- int8 MLP quantisation and the device metrics (no hand-written kernel:
# torch._int_mm and plain torch, held against the CPU route) ----


@pytest.mark.parametrize("rows", [17, 2 * 43009])
@pytest.mark.parametrize("cin,cout", [(96, 384), (384, 96), (768, 3072)])
def test_quant_linear_w8a8_int_mm_matches_the_cpu(card, rows, cin, cout):
    """`QuantLinear` w8a8 through torch._int_mm on the card against its
    exact CPU product (int8 rows and scales, then int32 sums), bf16
    activations as the model's: the int8 rows bit for bit, the output
    within one bf16 ulp. The MViT MLP widths and the row counts of the
    full-width block (B=2, cls rows joined to 8*56*96 spatial rows)."""
    from diff_sal_tpu_torch.ops import quant as tq

    g = torch.Generator().manual_seed(rows + cin)
    lin = tq.QuantLinear(cin, cout, "w8a8")
    lin.weight_q.copy_(torch.randint(-127, 128, (cout, cin), generator=g, dtype=torch.int8))
    lin.weight_scale.uniform_(1e-3, 2e-3, generator=g)
    lin.bias.normal_(generator=g)
    x = torch.randn(rows, cin, generator=g).bfloat16()
    want = lin(x)
    got = lin.to("cuda")(x.to("cuda"))
    torch.cuda.synchronize()
    q_cpu, _ = tq._quant_rows(x)
    q_gpu, _ = tq._quant_rows(x.to("cuda"))
    assert torch.equal(q_gpu.cpu(), q_cpu)
    a = torch.randint(-127, 128, (rows, cin), generator=g, dtype=torch.int8)
    assert torch.equal(tq.int_mm(a.cuda(), lin.weight_q).cpu(), tq.int_mm(a, lin.weight_q.cpu()))
    torch.testing.assert_close(got.cpu().float(), want.float(), **BF16_TOL)


def test_int_mm_states_the_card_rule(card):
    from diff_sal_tpu_torch.ops import quant as tq

    a = torch.ones(16, 32, dtype=torch.int8, device="cuda")
    b = torch.ones(8, 32, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="16 rows"):
        tq.int_mm(a, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int_mm(torch.ones(32, 30, dtype=torch.int8, device="cuda"),
                  torch.ones(8, 30, dtype=torch.int8, device="cuda"))


def test_quant_mlp_w8_on_the_card_matches_the_cpu(card):
    from diff_sal_tpu_torch.models.layers import Mlp
    from diff_sal_tpu_torch.ops import quant as tq

    g = torch.Generator().manual_seed(0)
    mlp = Mlp(96, 384, quant="w8")
    fp = Mlp(96, 384)
    sd = tq.quantize_state_dict(fp.state_dict(), mlp.state_dict())
    mlp.load_state_dict(sd)
    x = torch.randn(3, 100, 96, generator=g)
    want = mlp(x)
    got = mlp.to("cuda")(x.to("cuda"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(224, 384), (36, 64)])
def test_device_metrics_on_the_card_match_the_cpu(card, hw):
    from diff_sal_tpu_torch.metrics import device as tdev

    g = torch.Generator().manual_seed(hw[0])
    sal = torch.rand(4, *hw, 1, generator=g)
    sal[1] = torch.round(sal[1] * 20) / 20  # ties
    gt = torch.rand(4, *hw, 1, generator=g)
    fix = (torch.rand(4, *hw, 1, generator=g) > 0.98).float()
    fix[3] = 0.0  # no fixations: NaN
    for fn, args in ((tdev.auc_judd, (sal, fix)), (tdev.nss_fix, (sal, fix)),
                     (tdev.cc_maps, (sal, gt)), (tdev.sim_maps, (sal, gt))):
        want = fn(*args)
        got = fn(*(a.cuda() for a in args))
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6, equal_nan=True)
