"""K4's and K9's host-side plans (`resize_plan` and `phase_plan` in
`diff_sal_tpu_torch/ops/resize.py`): the launch geometry `dsal_resize_sum`
(`csrc/resize.cu`) and `dsal_resize_phase_head` (`csrc/resize_phase.cu`)
take, both on the separable two-pass kernel of `csrc/separable.cuh`. Checked
on the CPU at the decoder's shapes (four task maps (7,12)..(56,96) into
112x192, C = 768 for K4, O = 96 for K9, B = 2), at phase 10's and phase 5's
small-model heads, at ragged outputs, at inputs larger than the output, for
n = 1..4 inputs, in bf16 and f32: that the bands, column tiles and channel
chunks cover every output once, that the chunks keep 16-byte groups, that a
CTA fits in shared memory (two to an SM), that the decoder's calls give
every SM a CTA, that every input column a tile's live taps reach (read from
`_tap_tables` / `_phase_tables`) lies inside the intermediate the plan
stages, that every row tap lies inside its input, and that the plan agrees
with the constants, the shared-memory size and the entry checks of the CUDA
source (transcribed)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diff_sal_tpu_torch.ops import resize as t_resize

CSRC = Path(t_resize.__file__).resolve().parent.parent / "csrc"
DECODER = ((7, 12), (14, 24), (28, 48), (56, 96))
# (B, out_hw, input shapes, C or O)
CASES = [
    (2, (112, 192), DECODER, 96),                                  # the decoder's head / sum
    (2, (64, 48), ((4, 3), (8, 6), (16, 12), (32, 24)), 96),        # phase 10's small models
    (2, (32, 48), ((2, 3), (4, 6), (8, 12), (16, 24)), 96),         # phase 5's / 8's small model
    (2, (37, 29), ((5, 7), (11, 3)), 16),                           # ragged, two inputs
    (1, (9, 50), ((3, 4),), 128),                                   # one input, O = 128
    (3, (21, 35), ((40, 70), (7, 9)), 32),                          # larger than the output
    (1, (7, 11), ((20, 30), (7, 11), (3, 5)), 24),                  # three inputs, two not smaller
    (2, (1, 1), ((1, 1),), 8),
    (1, (5, 600), ((2, 900), (5, 3)), 40),                          # wide: tiles split the columns
]
IDS = ["B{}-{}x{}-n{}-C{}".format(c[0], *c[1], len(c[2]), c[3]) for c in CASES]
DTYPES = [torch.bfloat16, torch.float32]
DT_IDS = ["bf16", "f32"]
KINDS = ["resize", "phase"]


def _vec(dtype):
    return 8 if dtype == torch.bfloat16 else 4


def _plan(kind, B, out_hw, shapes, C, dtype):
    """(plan, numpy tap tables, shifts, bytes of an intermediate element)."""
    H, W = out_hw
    if kind == "resize":
        plan = t_resize.resize_plan(B, H, W, C, shapes, dtype)
        idx, wts = t_resize._tap_arrays(shapes, out_hw)
        return plan, idx, wts, 1, 4
    plan = t_resize.phase_plan(B, H, W, shapes, C, dtype)
    idx, wts = t_resize._phase_arrays(shapes, out_hw, dtype)
    return plan, idx, wts, 3, 2 if dtype == torch.bfloat16 else 4


def _cover(n, block, blocks):
    seen = np.zeros(blocks * block, np.int32)
    for i in range(blocks):
        seen[i * block:(i + 1) * block] += 1
    return seen[:n]


def test_the_tables_the_plans_read_are_the_kernels():
    """`_tap_tables` / `_phase_tables` hand the kernel the arrays the plans
    read."""
    for shapes, out_hw in ((DECODER, (112, 192)), (((40, 70), (7, 9)), (21, 35))):
        idx, wts = t_resize._tap_tables(shapes, out_hw, "cpu")
        a, b = t_resize._tap_arrays(shapes, out_hw)
        assert np.array_equal(idx.numpy(), a) and np.array_equal(wts.numpy(), b)
        for dt in DTYPES:
            idx, wts = t_resize._phase_tables(shapes, out_hw, dt, "cpu")
            a, b = t_resize._phase_arrays(shapes, out_hw, dt)
            assert np.array_equal(idx.numpy(), a) and np.array_equal(wts.numpy(), b)
            assert np.array_equal(b, torch.from_numpy(b).to(dt).float().numpy())


def _walk(plan, B, H, W, C):
    """The (band, chunk start, b, column tile) of every unit the persistent
    CTAs take, as the kernel decomposes them (bands fastest)."""
    bands, chunks = -(-H // plan.bh), -(-C // plan.cc)
    seen = []
    for cta in range(plan.ctas):
        for unit in range(cta, plan.units, plan.ctas):
            u = unit
            band = u % bands
            u //= bands
            c0 = (u % chunks) * plan.cc
            u //= chunks
            seen.append((band, c0, u % B, u // B))
    return seen


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("B,out_hw,shapes,C", CASES, ids=IDS)
def test_every_output_is_covered_once_in_16_byte_groups(kind, dtype, B, out_hw, shapes, C):
    """The persistent CTAs walk every unit once; the units' bands, column
    tiles and channel chunks cover every output row, column and channel of
    every batch item once; chunks are whole groups of 16 bytes of
    channels."""
    H, W = out_hw
    plan, *_ = _plan(kind, B, out_hw, shapes, C, dtype)
    V = _vec(dtype)
    bands, chunks, tiles = -(-H // plan.bh), -(-C // plan.cc), -(-W // plan.tw)
    assert plan.units == bands * chunks * tiles * B
    assert plan.ctas == min(plan.units, t_resize.SEP_CTAS_PER_SM * t_resize.NUM_SMS)
    seen = np.zeros((B, bands * plan.bh, tiles * plan.tw, chunks * plan.cc), np.int32)
    for band, c0, b, t in _walk(plan, B, H, W, C):
        seen[b, band * plan.bh:(band + 1) * plan.bh, t * plan.tw:(t + 1) * plan.tw,
             c0:c0 + plan.cc] += 1
    assert (seen[:, :H, :W, :C] == 1).all()
    assert (bands - 1) * plan.bh < H and (tiles - 1) * plan.tw < W and (chunks - 1) * plan.cc < C
    assert plan.bh in t_resize.SEP_BANDS and plan.cc % V == 0 and plan.cc >= V
    assert plan.cc * dtype.itemsize % 16 == 0  # every chunk starts on 16 bytes
    assert plan.tw <= t_resize.SEP_TW_MAX


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("B,out_hw,shapes,C", CASES, ids=IDS)
def test_a_cta_fits_two_to_an_sm(kind, dtype, B, out_hw, shapes, C):
    """The intermediate, the staged taps and the windows' weights fit a
    CTA, two to an SM (each CTA also holds 1 KB), and the plan starts at
    most two CTAs per SM."""
    plan, idx, _, ns, mid = _plan(kind, B, out_hw, shapes, C, dtype)
    n = len(shapes)
    assert plan.smem == t_resize.sep_smem(n, ns, plan.bh, plan.tw, plan.cols, plan.cc, mid)
    assert plan.smem <= t_resize.SEP_SMEM <= t_resize.SMEM_MAX
    assert 2 * (plan.smem + 1024) <= t_resize.SM_SMEM
    assert plan.ctas <= t_resize.SEP_CTAS_PER_SM * t_resize.NUM_SMS
    assert idx.shape[0] == n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("B,out_hw,shapes,C", CASES, ids=IDS)
def test_the_staged_columns_hold_every_live_tap(kind, dtype, B, out_hw, shapes, C):
    """Per column tile, as the kernel finds them: [cmin_i, cmax_i] over the
    tile's live column taps (weight non-zero) of every shift, the inputs'
    ranges laid end to end in the intermediate, within the plan's `cols`;
    every live tap's column and row inside its input."""
    H, W = out_hw
    plan, idx, wts, ns, _ = _plan(kind, B, out_hw, shapes, C, dtype)
    n = len(shapes)
    assert plan.cols == max(1, sum(plan.spans))
    for i, (h, w) in enumerate(shapes):
        rows, rw = idx[i, :, :ns * H], wts[i, :, :ns * H]
        assert ((rows[rw != 0] >= 0) & (rows[rw != 0] < h)).all()
        cols, cw = idx[i, :, ns * H:], wts[i, :, ns * H:]
        assert ((cols[cw != 0] >= 0) & (cols[cw != 0] < w)).all()
    for x0 in range(0, W, plan.tw):
        off = 0
        for i in range(n):
            c = idx[i, :, ns * H:].reshape(2, ns, W)[..., x0:x0 + plan.tw]
            live = wts[i, :, ns * H:].reshape(2, ns, W)[..., x0:x0 + plan.tw] != 0
            if not live.any():
                continue
            cmin, cmax = c[live].min(), c[live].max()
            assert cmax - cmin + 1 <= plan.spans[i]
            slots = off + c[live] - cmin  # the kernel's column in the intermediate
            assert (slots >= off).all() and (slots < off + plan.spans[i]).all()
            off += cmax - cmin + 1
        assert off <= plan.cols


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_the_decoders_calls_reach_every_sm(kind, dtype):
    """At B = 2 the decoder's sum (C = 768) and head (O = 96), and the small
    models' calls, put two persistent CTAs on every SM, each walking at
    least two units where the smallest unit (one row, 16 bytes of
    channels) allows."""
    C = 768 if kind == "resize" else 96
    for out_hw, shapes in (((112, 192), DECODER), ((64, 48), CASES[1][2]),
                           ((32, 48), CASES[2][2])):
        plan, *_ = _plan(kind, 2, out_hw, shapes, C, dtype)
        assert plan.ctas == 2 * t_resize.NUM_SMS, (out_hw, plan)
        assert (plan.units >= t_resize.SEP_UNITS_PER_CTA * plan.ctas
                or (plan.bh, plan.cc) == (1, _vec(dtype))), (out_hw, plan)
    plan, *_ = _plan(kind, 2, (112, 192), DECODER, C, dtype)
    assert plan.units >= t_resize.SEP_UNITS_PER_CTA * plan.ctas
    assert plan.tw == 192 and plan.spans == (12, 24, 48, 96)


def test_the_decoders_plans():
    """What the card runs: K4 in units of two rows and 64 channels (1344
    units, ~102 KB a CTA), K9 in units of 64 bytes of channels, one row
    in bf16 (672 units) and two in f32 (672); 264 persistent CTAs each."""
    for dt in DTYPES:
        p = t_resize.resize_plan(2, 112, 192, 768, DECODER, dt)
        assert (p.bh, p.cc, p.units, p.ctas) == (2, 64, 1344, 264)
    p = t_resize.phase_plan(2, 112, 192, DECODER, 96, torch.bfloat16)
    assert (p.bh, p.cc, p.units, p.ctas) == (1, 32, 672, 264)
    p = t_resize.phase_plan(2, 112, 192, DECODER, 96, torch.float32)
    assert (p.bh, p.cc, p.units, p.ctas) == (2, 16, 672, 264)


def test_tall_outputs_fit():
    """A CTA stages only its band's row taps, so an output of any height
    fits (the first kernel took every height)."""
    for kind, C in (("resize", 768), ("phase", 96)):
        plan, *_ = _plan(kind, 1, (2000, 30), ((500, 15), (2000, 30)), C, torch.float32)
        assert plan.smem <= t_resize.SEP_SMEM and plan.tw == 30


def test_wide_inputs_split_the_columns():
    """An input much wider than the tile's share of the intermediate: the
    plan narrows the column tiles until a band fits."""
    p = t_resize.phase_plan(1, 5, 600, ((2, 9000), (5, 3)), 40, torch.float32)
    assert p.tw < 256 and p.smem <= t_resize.SEP_SMEM


@pytest.mark.parametrize("fn,args", [
    (t_resize.resize_plan, (2, 8, 8, 12, ((4, 4),), torch.bfloat16)),      # C % 8
    (t_resize.resize_plan, (2, 8, 8, 6, ((4, 4),), torch.float32)),        # C % 4
    (t_resize.resize_plan, (2, 8, 8, 16, ((4, 4),), torch.float16)),       # dtype
    (t_resize.resize_plan, (2, 8, 8, 16, (), torch.bfloat16)),             # no input
    (t_resize.resize_plan, (2, 8, 8, 16, ((4, 4),) * 5, torch.bfloat16)),  # five inputs
    (t_resize.resize_plan, (0, 8, 8, 16, ((4, 4),), torch.bfloat16)),
    (t_resize.phase_plan, (2, 8, 8, ((4, 4),), 136, torch.bfloat16)),      # O > 128
    (t_resize.phase_plan, (2, 8, 8, ((4, 4),), 12, torch.bfloat16)),       # O % 8
    (t_resize.phase_plan, (2, 8, 8, ((4, 4),), 6, torch.float32)),         # O % 4
    (t_resize.phase_plan, (2, 8, 8, ((0, 4),), 8, torch.float32)),
])
def test_plans_refuse_what_the_kernels_do_not_take(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _entry_accepts(n, B, H, W, C, V, bh, cc, tw, cols, ctas, ns, mid, hs, ws):
    """The checks of `sep::launch`, which both entries call, transcribed."""
    if (n < 1 or n > 4 or B < 1 or H < 1 or W < 1 or C < V or C % V or cc < V or cc % V
            or tw < 1 or cols < 1 or ctas < 1 or bh not in (1, 2, 4)):
        return False
    if any(h < 1 or w < 1 for h, w in zip(hs[:n], ws[:n])):
        return False
    units = -(-H // bh) * -(-C // cc) * B * -(-W // tw)
    smem = ((n * ns * tw + n * ns * bh) * 16 + 48 * 4 + bh * cols * ns * cc * mid
            + n * ns * bh * (bh + 1) * 4)
    return units < 2 ** 31 and smem <= 232448


def test_plans_mirror_the_kernel_source():
    """The constants the plans share with csrc/separable.cuh, the bands its
    dispatch instantiates, its shared-memory size, the entries' trailing
    plan arguments, and its checks, transcribed, at every case."""
    src = (CSRC / "separable.cuh").read_text()
    assert _constant(src, "THREADS") == t_resize.SEP_THREADS
    assert _constant(src, "STRIP") == t_resize.SEP_STRIP
    assert _constant(src, "SMEM_MAX") == t_resize.SMEM_MAX
    assert _constant(src, "INTS") * 4 == t_resize.SEP_INT_BYTES
    assert _constant(src, "MAX_INPUTS") == t_resize.MAX_INPUTS
    assert "case 1: return launch_bh<T, M, NS, 1>" in src
    assert "case 2: return launch_bh<T, M, NS, 2>" in src
    assert "default: return launch_bh<T, M, NS, 4>" in src and set(t_resize.SEP_BANDS) == {1, 2, 4}
    assert "(bh != 1 && bh != 2 && bh != 4)" in src
    assert "dim3 grid(min(ctas, a.units));" in src  # persistent CTAs walk the units
    assert ("const int band = u % bands;\n    u /= bands;\n    const int c0 = (u % chunks) * cc;\n"
            "    u /= chunks;\n    const int b = u % a.B, t = u / a.B;") in src  # as _walk
    assert "struct Tap {\n  int lo, hi;\n  float wl, wh;\n};" in src  # 16 bytes
    assert ("(long long)(n * ns * tw + n * ns * bh) * (long long)sizeof(Tap) + INTS * 4 +\n"
            "         (long long)bh * cols * ns * cc * mid_bytes + "
            "(long long)n * ns * bh * (bh + 1) * 4;") in src
    assert "__launch_bounds__(THREADS, 2)" in src and t_resize.SEP_CTAS_PER_SM == 2
    for source, kern, ns in (("resize.cu", t_resize.KERNEL, 1),
                             ("resize_phase.cu", t_resize.PHASE_KERNEL, 3)):
        text = (CSRC / source).read_text()
        assert '#include "separable.cuh"' in text and f", {ns}>(a, bh, ctas, s)" in text
        sig = re.search(r'extern "C" int ' + kern.entry + r"\(([^)]*)\)", text).group(1)
        names = [a.split()[-1] for a in sig.split(",")]
        assert names[-7:] == ["bh", "cc", "tw", "cols", "ctas", "is_bf16", "stream"]
        assert len(names) == len(kern.argtypes)
    for kind in KINDS:
        for dtype in DTYPES:
            for B, out_hw, shapes, C in CASES:
                p, _, _, ns, mid = _plan(kind, B, out_hw, shapes, C, dtype)
                hs, ws = [s[0] for s in shapes], [s[1] for s in shapes]
                assert _entry_accepts(len(shapes), B, *out_hw, C, _vec(dtype), p.bh, p.cc, p.tw,
                                      p.cols, p.ctas, ns, mid, hs, ws)
    ok = (1, 2, 8, 8, 16, 8, 2, 16, 8, 4, 264, 1, 4, [4], [4])
    assert _entry_accepts(*ok)
    assert not _entry_accepts(*ok[:6], 3, *ok[7:])                      # no such band
    assert not _entry_accepts(*ok[:7], 12, *ok[8:])                     # chunk not whole groups
    assert not _entry_accepts(*ok[:9], 100000, *ok[10:])                # beyond shared memory
    assert not _entry_accepts(*ok[:10], 0, *ok[11:])                    # no CTA
    assert not _entry_accepts(5, *ok[1:])                               # five inputs
