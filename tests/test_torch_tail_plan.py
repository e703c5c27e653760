"""The host-side plan of the bf16 K3 block-tail kernel (`tail_plan` in
`diff_sal_tpu_torch/ops/mlp.py`): the geometry `csrc/mlp.cu` launches
with, checked on the CPU at the SalUNet decoder's widths (C = 96, 192, 384,
768, Hd = 2C) over the row counts its four stages produce at B = 1, 2 and 4
with four or eight frames (and ragged counts): that a CTA fits in shared
memory, that the row tiles, column splits and hidden splits cover every
(row, output column, hidden chunk) exactly once, that C = 768 fills the
card, and that the plan agrees with the constants and checks of the CUDA
source."""

import re
from pathlib import Path

import numpy as np
import pytest

from diff_sal_tpu_torch.ops import mlp as t_mlp

CSRC = Path(t_mlp.__file__).resolve().parent.parent / "csrc" / "mlp.cu"

# decoder stage (C, token grid per frame) at 224x384
STAGES = [(768, 7 * 12), (384, 14 * 24), (192, 28 * 48), (96, 56 * 96)]
CASES = sorted({(B * T * hw, C) for C, hw in STAGES for B in (1, 2, 4) for T in (4, 8)}
               | {(R, C) for C, _ in STAGES for R in (1, 2, 63, 64, 65, 333, 1000, 5000)})
IDS = [f"R{R}-C{C}" for R, C in CASES]


@pytest.mark.parametrize("R,C", CASES, ids=IDS)
def test_plan_fits_a_cta(R, C):
    plan = t_mlp.tail_plan(R, C, 2 * C)
    assert plan.smem == t_mlp.tail_smem(C, plan.stages) <= t_mlp.SMEM_MAX
    assert 1 <= plan.nt <= t_mlp.TAIL_MAX_NT  # at most 128 f32 accumulators a thread
    assert C % (32 * plan.kb) == 0  # every w1 tile holds whole boxes
    assert plan.wgs in (1, 2) and plan.stages == t_mlp.TAIL_STAGES[plan.wgs]
    # every warpgroup its own part of the ring, at least two buffers deep
    assert plan.stages % plan.wgs == 0 and plan.stages // plan.wgs >= 2
    # the epilogue's f32 sums (64 x 64 nt) fit where LN(y) and the ring were
    assert 64 * plan.nt * 64 * 4 <= 64 * C * 2 + plan.stages * t_mlp.TAIL_TILE
    if plan.wgs == 2:
        assert plan.chunks >= 2
    else:  # several CTAs per SM: 228 KB less 1 KB reserved per CTA
        assert 2 * (plan.smem + 1024) <= t_mlp.SM_SMEM


@pytest.mark.parametrize("R,C", CASES, ids=IDS)
def test_grid_covers_every_row_column_and_hidden_chunk_once(R, C):
    Hd = 2 * C
    plan = t_mlp.tail_plan(R, C, Hd)
    tiles, chunks = -(-C // 64), Hd // 64
    assert plan.nt * plan.col_splits == tiles
    assert plan.chunks * plan.k_splits == chunks and plan.k_splits <= t_mlp.TAIL_MAX_KSPLIT
    assert plan.row_tiles == -(-R // 64)
    assert plan.ctas == plan.row_tiles * plan.col_splits * plan.k_splits
    seen = np.zeros((plan.row_tiles * 64, tiles, chunks), np.int32)
    for x in range(plan.row_tiles):  # the kernel's blockIdx.x, y, z
        for y in range(plan.col_splits):
            for z in range(plan.k_splits):
                seen[64 * x:64 * x + 64, plan.nt * y:plan.nt * (y + 1),
                     plan.chunks * z:plan.chunks * (z + 1)] += 1
    assert (seen[:R] == 1).all()
    # no CTA without rows, no output tile past C
    assert (plan.row_tiles - 1) * 64 < R and (plan.col_splits * plan.nt - 1) * 64 < C


@pytest.mark.parametrize("R,C", CASES, ids=IDS)
def test_the_hidden_axis_splits_only_where_the_card_would_idle(R, C):
    plan = t_mlp.tail_plan(R, C, 2 * C)
    base = plan.row_tiles * plan.col_splits
    if 2 * base > t_mlp.NUM_SMS:
        assert plan.k_splits == 1
    else:  # the largest split (a divisor of the chunks) that keeps one CTA per SM
        assert plan.ctas <= t_mlp.NUM_SMS
        for d in range(plan.k_splits + 1, t_mlp.TAIL_MAX_KSPLIT + 1):
            assert (2 * C // 64) % d or base * d > t_mlp.NUM_SMS


@pytest.mark.parametrize("B,T", [(1, 4), (1, 8), (2, 4), (2, 8), (4, 4), (4, 8)])
def test_the_first_decoder_stage_fills_the_card(B, T):
    """C = 768: 64-row tiles and three column splits leave most SMs idle at
    the decoder's first stage (63 CTAs at B = 2); with the hidden split the
    busiest SM does at most a quarter more than an even spread of the
    work over 132 SMs (one CTA per SM at this width)."""
    plan = t_mlp.tail_plan(B * T * 84, 768, 1536)
    busiest = -(-plan.ctas // t_mlp.NUM_SMS) * plan.chunks
    even = plan.row_tiles * plan.col_splits * (1536 // 64) / t_mlp.NUM_SMS
    assert plan.k_splits > 1 or B == 4
    assert busiest <= 1.25 * even


@pytest.mark.parametrize("R,C,Hd", [(100, 80, 160), (100, 800, 1600), (100, 16, 32),
                                    (100, 96, 100), (100, 96, 32), (0, 96, 192)])
def test_plan_refuses_what_the_kernel_does_not_take(R, C, Hd):
    with pytest.raises(ValueError):
        t_mlp.tail_plan(R, C, Hd)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = ([\d ]+?)(?:;| \*)", src).group(1))


def test_plan_mirrors_the_kernel_source():
    """The constants the plan shares with csrc/mlp.cu, the shared-memory
    formula and the entry's trailing plan arguments."""
    src = CSRC.read_text()
    assert _constant(src, "BM") == t_mlp.TAIL_ROWS
    assert _constant(src, "HC") == t_mlp.TAIL_CHUNK
    assert "constexpr int BOX = 64 * 64;" in src and "constexpr int TILE = 2 * BOX;" in src
    assert 2 * 64 * 64 == t_mlp.TAIL_TILE
    assert _constant(src, "MAX_NT") == t_mlp.TAIL_MAX_NT
    assert _constant(src, "MAX_STAGES") == t_mlp.TAIL_MAX_STAGES
    assert _constant(src, "MAX_KSPLIT") == t_mlp.TAIL_MAX_KSPLIT
    assert _constant(src, "SMEM_MAX") == t_mlp.SMEM_MAX
    assert _constant(src, "MAXC") == t_mlp.MAX_C
    assert "return BM * C * 2 + stages * (TILE + 8) + 1024;" in src
    sig = re.search(r'extern "C" int dsal_block_tail\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in sig.split(",")][-6:] == ["nt", "col_splits", "k_splits",
                                                             "wgs", "stages", "stream"]
    assert "__launch_bounds__(NW * 128, 1)" in src


def _entry_accepts(R, C, Hd, plan, with_ws):
    """The checks of the C entry `dsal_block_tail`, transcribed."""
    if R < 1 or C < 32 or C % 32 or C > t_mlp.MAX_C or Hd < 64 or Hd % 64:
        return False
    chunks = Hd // 64
    return (1 <= plan.nt <= t_mlp.TAIL_MAX_NT and plan.nt * plan.col_splits == -(-C // 64)
            and 1 <= plan.k_splits <= t_mlp.TAIL_MAX_KSPLIT and chunks % plan.k_splits == 0
            and (plan.k_splits > 1) == with_ws and plan.wgs in (1, 2)
            and 2 * plan.wgs <= plan.stages <= t_mlp.TAIL_MAX_STAGES
            and plan.stages % plan.wgs == 0
            and t_mlp.tail_smem(C, plan.stages) <= t_mlp.SMEM_MAX
            and 64 * plan.nt * 64 * 4 <= 64 * C * 2 + plan.stages * t_mlp.TAIL_TILE)


def test_the_entry_takes_every_plan_and_refuses_a_mismatched_one():
    for R, C in CASES:
        plan = t_mlp.tail_plan(R, C, 2 * C)
        assert _entry_accepts(R, C, 2 * C, plan, plan.k_splits > 1), (R, C)
    plan = t_mlp.tail_plan(1344, 768, 1536)
    assert plan.k_splits > 1
    assert not _entry_accepts(1344, 768, 1536, plan, with_ws=False)  # no workspace
    assert not _entry_accepts(1344, 384, 768, plan, True)  # tiles do not cover C
