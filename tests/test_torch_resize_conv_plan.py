"""K8's host-side plan (`conv_plan` in `diff_sal_tpu_torch/ops/resize.py`):
the geometry `dsal_resize_conv_relu` (bf16) and `dsal_resize_conv_relu_f32`
in `csrc/resize_conv.cu` launch with, checked on the CPU at the decoder
head's shape (C = 768, O = 96, out 112x192, B = 2), at O = 16 and 128 and
at ragged H and W: that the tiles cover every output pixel once and the
chunks every channel once, that a CTA fits in shared memory, that the
products' width is the one the kernels take, that the plan agrees with the
constants and checks of the CUDA source; and, transcribed from the bf16
kernel, that the shared-memory address each wgmma descriptor reads for tap
(dy, dx) is the one the producers wrote for halo pixel (y + dy, x + dx)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diff_sal_tpu_torch.ops import resize as t_resize

CSRC = Path(t_resize.__file__).resolve().parent.parent / "csrc" / "resize_conv.cu"
DTYPES = [torch.bfloat16, torch.float32]
CASES = [(2, 112, 192, 768, 96), (2, 112, 192, 768, 16), (2, 112, 192, 768, 128),
         (2, 64, 48, 768, 96), (1, 37, 29, 32, 16), (3, 9, 50, 48, 128), (1, 1, 1, 16, 48),
         (2, 21, 35, 80, 80), (4, 113, 191, 784, 112)]
IDS = ["B{}-{}x{}-C{}-O{}".format(*c) for c in CASES]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,W,C,O", CASES, ids=IDS)
def test_tiles_cover_every_pixel_and_chunks_every_channel_once(B, H, W, C, O, dtype):
    plan = t_resize.conv_plan(B, H, W, C, O, dtype)
    th, tw = t_resize.CONV_TILE
    gx, gy, gb = plan.grid
    seen = np.zeros((gy * th, gx * tw), np.int32)
    for y in range(gy):  # the kernel's blockIdx.y, x
        for x in range(gx):
            seen[th * y:th * (y + 1), tw * x:tw * (x + 1)] += 1
    assert (seen[:H, :W] == 1).all() and gb == B
    assert (gy - 1) * th < H and (gx - 1) * tw < W  # no tile wholly past the map
    assert plan.chunks * plan.kc >= C > (plan.chunks - 1) * plan.kc


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,W,C,O", CASES, ids=IDS)
def test_a_cta_fits_and_the_width_is_taken(B, H, W, C, O, dtype):
    plan = t_resize.conv_plan(B, H, W, C, O, dtype)
    assert plan.smem == t_resize.conv_smem(plan.np_, dtype) <= t_resize.SMEM_MAX
    assert plan.np_ in t_resize.CONV_WIDTHS and plan.np_ >= O
    assert plan.np_ == min(w for w in t_resize.CONV_WIDTHS if w >= O)
    assert plan.threads == (384 if dtype == torch.bfloat16 else 256)


def test_the_heads_patches_fit_their_buffer():
    """The bf16 producers stage, per tile and chunk, every input pixel the
    halo's taps reach; at the head's shape (and at phase 10's) the four
    inputs' pixels fit one buffer on every tile, so no input reads device
    memory tap by tap."""
    th, tw = t_resize.CONV_TILE
    for (H, W), shapes in (((112, 192), [(7, 12), (14, 24), (28, 48), (56, 96)]),
                           ((64, 48), [(4, 3), (8, 6), (16, 12), (32, 24)])):
        worst = 0
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                tot = 0
                for h, w in shapes:
                    rl, rh, _, _ = t_resize._taps(h, H)
                    cl, chh, _, _ = t_resize._taps(w, W)
                    ys = [y for y in range(y0 - 1, y0 + th + 1) if 0 <= y < H]
                    xs = [x for x in range(x0 - 1, x0 + tw + 1) if 0 <= x < W]
                    nr = max(rh[y] for y in ys) - min(rl[y] for y in ys) + 1
                    nc = max(chh[x] for x in xs) - min(cl[x] for x in xs) + 1
                    assert nr <= th + 3 and nc <= tw + 3
                    tot += nr * nc
                worst = max(worst, tot)
        assert worst * 80 <= t_resize.CONV_PATCH_BYTES, (H, W, worst)


def test_the_head_takes_one_wave_of_full_width_products():
    """At the head's shape: O = 96 is a wgmma width of its own (no padded
    columns), 336 tiles for 132 SMs, 24 bf16 chunks of 32 channels."""
    plan = t_resize.conv_plan(2, 112, 192, 768, 96, torch.bfloat16)
    assert plan.np_ == 96 and plan.grid == (12, 14, 2) and plan.chunks == 24
    assert t_resize.conv_plan(2, 112, 192, 768, 96, torch.float32).chunks == 48


@pytest.mark.parametrize("args", [(2, 8, 8, 40, 16), (2, 8, 8, 32, 24), (2, 8, 8, 32, 144),
                                  (2, 8, 8, 8, 16), (0, 8, 8, 32, 16)])
def test_plan_refuses_what_the_kernels_do_not_take(args):
    for dt in DTYPES:
        with pytest.raises(ValueError):
            t_resize.conv_plan(*args, dt)
    with pytest.raises(ValueError):
        t_resize.conv_plan(2, 8, 8, 32, 16, torch.float16)


# transcribed from csrc/resize_conv.cu (bf16): the producers' store address
# of channel k of halo pixel (hy, hx) in dx copy d, and the byte address a
# K-major no-swizzle wgmma descriptor (start, LBO 128, SBO 256) gives row r,
# column k of its 64 x 16 A tile
TH, TW, HR, HC = 8, 16, 10, 18
AKB, ABUF = HR * TW * 32, 2 * HR * TW * 32


def _store(d, hy, hx, k):
    m = hy * TW + (hx - d)
    grp = k // 8
    return (d * ABUF + (grp >> 1) * AKB + (m >> 3) * 256 + (grp & 1) * 128 + (m & 7) * 16
            + (k % 8) * 2)


def _desc_read(start, r, k):
    return start + (r // 8) * 256 + (k // 8) * 128 + (r % 8) * 16 + (k % 8) * 2


def test_each_tap_reads_the_halo_pixel_it_shifts_to():
    written = {}
    for hy in range(HR):
        for hx in range(HC):
            for d in range(3):
                if 0 <= hx - d < TW:
                    for k in range(32):
                        a = _store(d, hy, hx, k)
                        assert a not in written
                        written[a] = (hy, hx, k)
    assert len(written) == 3 * HR * TW * 32 and max(written) < 3 * ABUF
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for kk in range(2):
            for h in range(2):
                start = dx * ABUF + kk * AKB + (2 * dy + 8 * h) * 256  # the consumer's descriptor
                for r in range(64):
                    m = 64 * h + r  # output pixel (m // 16, m % 16) of the tile
                    for k in range(16):
                        hy, hx, ch = written[_desc_read(start, r, k)]
                        assert (hy, hx, ch) == (m // TW + dy, m % TW + dx, 16 * kk + k)


def _constant(src, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split("//")[0].strip()


def test_plan_mirrors_the_kernel_source():
    """The tile, chunk, stage and thread constants, the shared-memory
    formulas, the widths `pad_o` takes, and the entries' arguments and
    checks."""
    src = CSRC.read_text()
    assert (int(_constant(src, "TH")), int(_constant(src, "TW"))) == t_resize.CONV_TILE
    assert int(_constant(src, "KC")) == t_resize.CONV_KC[torch.bfloat16]
    assert int(_constant(src, "FKC")) == t_resize.CONV_KC[torch.float32]
    assert int(_constant(src, "STAGES")) == t_resize.CONV_STAGES
    assert int(_constant(src, "PRODUCERS")) + 128 == t_resize.CONV_THREADS[torch.bfloat16]
    assert _constant(src, "FTHREADS") == "32 * TH"
    assert int(_constant(src, "SMEM_MAX")) == t_resize.SMEM_MAX
    assert _constant(src, "TABLE_BYTES") == "MAX_IN * (HR + HC) * 16"
    assert "return A_BYTES + 9 * np * 64; }" in src
    assert ("return 1024 + STAGES * conv_stage_bytes(np) + 16 * STAGES + TABLE_BYTES + "
            "MAX_IN * 32 +\n         2 * PATCH_BYTES;") in src
    assert _constant(src, "PATCH_BYTES") == "PATCH_PIX * PIX"
    assert int(_constant(src, "PATCH_PIX")) * (32 * 2 + 16) == t_resize.CONV_PATCH_BYTES
    assert _constant(src, "PIX") == "KC * 2 + 16"
    assert "return 2 * HALO * FHS * 4 + 2 * 9 * FKC * (np + 8) * 4 + TABLE_BYTES;" in src
    assert _constant(src, "FHS") == "FKC + 4"
    assert "const int widths[5] = {32, 48, 64, 96, 128};" in src
    assert tuple(t_resize.CONV_WIDTHS) == (32, 48, 64, 96, 128)
    for entry, kern in (("dsal_resize_conv_relu", t_resize.CONV_KERNEL),
                        ("dsal_resize_conv_relu_f32", t_resize.CONV_F32_KERNEL)):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
        names = [a.split()[-1] for a in sig.split(",")]
        assert names[-3:] == ["O", "np", "stream"] and len(names) == len(kern.argtypes)
    assert ("if (n < 1 || n > MAX_IN || H < 1 || W < 1 || C < 16 || C % 16 != 0 || O < 16 || "
            "O % 16 != 0 ||\n      O > 128 || np != pad_o(O))") in src
