"""The host-side plan of K3's f32 instance (`tail_f32_plan` in
`diff_sal_tpu_torch/ops/mlp.py`): the geometry `dsal_block_tail_f32` in
`csrc/mlp.cu` launches with, checked on the CPU at the SalUNet decoder's
widths (C = 96, 192, 384, 768, Hd = 2C) over the row counts its four
stages produce at full width (B = 1, 2 and 4, four or eight frames), at
phase 10's small model and at ragged counts, and at every other width the
entry takes (C = 32..768 in steps of 32): that a CTA fits in shared memory,
that the row tiles, column splits and hidden splits cover every (row,
output column, hidden chunk) exactly once, that the hidden axis splits only
where the card would idle, and that the plan agrees with the constants and
checks of the CUDA source."""

import re
from pathlib import Path

import numpy as np
import pytest

from diff_sal_tpu_torch.ops import mlp as t_mlp

CSRC = Path(t_mlp.__file__).resolve().parent.parent / "csrc" / "mlp.cu"

# decoder stage (C, token grid per frame) at 224x384, and at phase 10's 128x96
STAGES = [(768, 7 * 12), (384, 14 * 24), (192, 28 * 48), (96, 56 * 96)]
SMALL = [(768, 4 * 3), (384, 8 * 6), (192, 16 * 12), (96, 32 * 24)]
CASES = sorted({(B * T * hw, C) for C, hw in STAGES + SMALL for B in (1, 2, 4) for T in (4, 8)}
               | {(R, C) for C, _ in STAGES for R in (1, 2, 31, 32, 33, 333, 1000, 5000)}
               | {(R, C) for C in range(32, 769, 32) for R in (1, 100, 4000)})
IDS = [f"R{R}-C{C}" for R, C in CASES]


def _slots(plan):
    return t_mlp.NUM_SMS * max(1, min(2, t_mlp.SM_SMEM // (plan.smem + 1024)))


@pytest.mark.parametrize("R,C", CASES, ids=IDS)
def test_plan_fits_a_cta(R, C):
    plan = t_mlp.tail_f32_plan(R, C, 2 * C)
    nc = 32 * plan.nt
    assert plan.smem == t_mlp.tail_f32_smem(C, nc, plan.hc) <= t_mlp.SMEM_MAX
    assert plan.smem == 4 * (32 * (C + 8) + 32 * (plan.hc + 8)
                             + 2 * max(plan.hc * 40, nc * 24))
    # at most 384 output columns per CTA: 12 n-tiles of f32 sums a warp
    assert 1 <= plan.nt <= 12 and nc <= t_mlp.F32_MAX_NC
    assert plan.hc in (64, 128)
    assert plan.hc == 64 or plan.nt in t_mlp.F32_WIDE_NT


@pytest.mark.parametrize("R,C", CASES, ids=IDS)
def test_grid_covers_every_row_column_and_hidden_chunk_once(R, C):
    Hd = 2 * C
    plan = t_mlp.tail_f32_plan(R, C, Hd)
    ntiles, chunks = C // 32, Hd // plan.hc  # 32-column blocks (four warps' 8 columns)
    assert plan.nt * plan.col_splits == ntiles
    assert plan.chunks * plan.k_splits == chunks and plan.k_splits <= t_mlp.F32_MAX_KSPLIT
    assert plan.row_tiles == -(-R // 32)
    assert plan.ctas == plan.row_tiles * plan.col_splits * plan.k_splits
    seen = np.zeros((plan.row_tiles * 32, ntiles, chunks), np.int32)
    for x in range(plan.row_tiles):  # the kernel's blockIdx.x, y, z
        for y in range(plan.col_splits):
            for z in range(plan.k_splits):
                seen[32 * x:32 * x + 32, plan.nt * y:plan.nt * (y + 1),
                     plan.chunks * z:plan.chunks * (z + 1)] += 1
    assert (seen[:R] == 1).all()
    # no CTA without rows
    assert (plan.row_tiles - 1) * 32 < R
    # inside a CTA: warp (wm, wq) owns rows 16 wm.. and, in the second
    # product, columns [8 nt wq, + 8 nt): the four column groups cover the
    # CTA's 32 nt columns once; in the first product hidden n-tiles
    # [hc / 32 wq, + hc / 32) cover the chunk's hc / 8 once
    cols = np.zeros(32 * plan.nt, np.int32)
    hid = np.zeros(plan.hc // 8, np.int32)
    for wq in range(4):
        cols[8 * plan.nt * wq:8 * plan.nt * (wq + 1)] += 1
        hid[plan.hc // 32 * wq:plan.hc // 32 * (wq + 1)] += 1
    assert (cols == 1).all() and (hid == 1).all()


@pytest.mark.parametrize("R,C", CASES, ids=IDS)
def test_the_hidden_axis_splits_only_where_the_card_would_idle(R, C):
    plan = t_mlp.tail_f32_plan(R, C, 2 * C)
    base = plan.row_tiles * plan.col_splits
    if plan.k_splits > 1:
        assert plan.ctas <= _slots(plan)
        # the largest divisor of the chunks that keeps within the slots
        for d in range(plan.k_splits + 1, t_mlp.F32_MAX_KSPLIT + 1):
            assert (2 * C // plan.hc) % d or base * d > _slots(plan)
    narrow = t_mlp.tail_f32_smem(C, 32 * plan.nt, 64)
    if 2 * base > t_mlp.NUM_SMS * max(1, min(2, t_mlp.SM_SMEM // (narrow + 1024))):
        assert plan.k_splits == 1


@pytest.mark.parametrize("B,T", [(1, 4), (1, 8), (2, 4), (2, 8)])
def test_the_wide_stages_at_full_width_take_chunks_of_128(B, T):
    """C = 768, 384, 192 at the decoder's full-width rows: four hidden
    n-tiles per warp in the first product, and C = 768 split in two columns
    and over the hidden axis into at least 100 of the 132 SMs."""
    for C, hw in STAGES[:3]:
        plan = t_mlp.tail_f32_plan(B * T * hw, C, 2 * C)
        assert plan.hc == 128, (C, plan)
    plan = t_mlp.tail_f32_plan(2 * 5 * 84, 768, 1536)  # a DDIM run's first stage
    assert (plan.col_splits, plan.k_splits) == (2, 2) and plan.ctas >= 100


def test_phase_10_shapes_split_the_hidden_axis():
    """The small model's few rows: at the three coarse stages the hidden
    split spreads them over dozens of CTAs; the finest has enough rows."""
    for C, hw in SMALL:
        plan = t_mlp.tail_f32_plan(2 * 5 * hw, C, 2 * C)
        assert plan.ctas >= 24 and (plan.k_splits > 1) == (C > 96), (C, plan)


@pytest.mark.parametrize("R,C,Hd", [(100, 80, 160), (100, 800, 1600), (100, 16, 32),
                                    (100, 96, 100), (100, 96, 32), (0, 96, 192)])
def test_plan_refuses_what_the_kernel_does_not_take(R, C, Hd):
    with pytest.raises(ValueError):
        t_mlp.tail_f32_plan(R, C, Hd)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
               .split("//")[0].replace("FK1 + 8", "40").replace("FK2 + 8", "24")
               .replace("F_MAX_NC / 32", "12").replace("FW * 32", "256"))


def test_plan_mirrors_the_kernel_source():
    """The constants the plan shares with the f32 instance in csrc/mlp.cu,
    the shared-memory formula, the wide-chunk rule and the entry's trailing
    plan arguments."""
    src = CSRC.read_text()
    assert _constant(src, "FR") == t_mlp.F32_ROWS
    assert _constant(src, "FTH") == t_mlp.F32_THREADS
    assert _constant(src, "FLD1") == t_mlp.F32_LD1
    assert _constant(src, "FLD2") == t_mlp.F32_LD2
    assert _constant(src, "F_MAX_NC") == t_mlp.F32_MAX_NC
    assert _constant(src, "F_MAX_KSPLIT") == t_mlp.F32_MAX_KSPLIT
    assert _constant(src, "SMEM_MAX") == t_mlp.SMEM_MAX
    assert _constant(src, "MAXC") == t_mlp.MAX_C
    assert "const int tile = hc * FLD1 > nc * FLD2 ? hc * FLD1 : nc * FLD2;" in src
    assert "return 4 * (FR * (C + 8) + FR * (hc + 8) + 2 * tile);" in src
    assert "return nt == 6 || nt == 12; }" in src
    assert tuple(t_mlp.F32_WIDE_NT) == (6, 12)
    sig = re.search(r'extern "C" int dsal_block_tail_f32\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in sig.split(",")][-5:] == ["nt", "col_splits", "hc",
                                                             "k_splits", "stream"]
    assert len(sig.split(",")) == len(t_mlp.F32_KERNEL.argtypes)
    assert "__launch_bounds__(FTH, 1) block_tail_f32_kernel" in src


def _entry_accepts(R, C, Hd, plan, with_ws):
    """The checks of the C entry `dsal_block_tail_f32`, transcribed."""
    hc = plan.hc
    if (R < 1 or C < 32 or C % 32 or C > t_mlp.MAX_C or hc not in (64, 128) or Hd < hc
            or Hd % hc or (hc == 128 and plan.nt not in t_mlp.F32_WIDE_NT)):
        return False
    chunks = Hd // hc
    return (1 <= plan.nt <= 12 and plan.nt * 32 * plan.col_splits == C
            and 1 <= plan.k_splits <= t_mlp.F32_MAX_KSPLIT and chunks % plan.k_splits == 0
            and (plan.k_splits > 1) == with_ws
            and t_mlp.tail_f32_smem(C, 32 * plan.nt, hc) <= t_mlp.SMEM_MAX)


def test_the_entry_takes_every_plan_and_refuses_a_mismatched_one():
    for R, C in CASES:
        plan = t_mlp.tail_f32_plan(R, C, 2 * C)
        assert _entry_accepts(R, C, 2 * C, plan, plan.k_splits > 1), (R, C)
    plan = t_mlp.tail_f32_plan(840, 768, 1536)
    assert plan.k_splits > 1 and plan.hc == 128
    fields = {f: getattr(plan, f) for f in plan.__dataclass_fields__}

    def bad(**kw):
        return not _entry_accepts(840, 768, 1536, t_mlp.TailF32Plan(**{**fields, **kw}), True)
    assert not _entry_accepts(840, 768, 1536, plan, with_ws=False)  # no workspace
    assert not _entry_accepts(840, 384, 768, plan, True)  # columns do not cover C
    assert bad(nt=4)  # 128 wide chunks only for nt 6 and 12
    assert bad(hc=96)
    assert bad(k_splits=5)  # not a divisor of the 12 chunks
    assert bad(k_splits=t_mlp.F32_MAX_KSPLIT + 1)
