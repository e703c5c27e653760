"""The host-side plan of the K2 LayerNorm kernel (`ln_plan` in
`diff_sal_tpu_torch/ops/layernorm.py`): the geometry `csrc/layernorm.cu`
launches with, checked on the CPU over the (rows, C) the paths produce
(MViTv2-small's widths 96-768 on the spatial rows and the 1-4 cls rows,
its per-head norms at C = 96 up to 86,018 rows, the decoder's 96-768, the
audio branch's 512) and up to MAX_C = 1024, in bf16 and f32: that a CTA's
ring fits in shared memory, that the persistent CTAs, the row groups and
the lanes cover every row and channel exactly once, and that the plan
agrees with the constants and checks of the CUDA source."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diff_sal_tpu_torch.ops import layernorm as t_ln

CSRC = Path(t_ln.__file__).resolve().parent.parent / "csrc" / "layernorm.cu"

# rows per call on the paths at B = 1, 2 and 4: cls rows (B), token grids
# of the four MViT stages and the decoder (43008 / 10752 / 2688 / 672 per
# clip), with the cls row (+B), per-head norms at (L + 1) rows per head, and
# ragged counts against every tile size
ROWS = [1, 2, 3, 4, 7, 64, 100, 257, 673, 1344, 2689, 5376, 10753, 21504, 43009, 86016,
        86018, 172036]
WIDTHS = [96, 192, 384, 512, 768, 1024]
DTYPES = [torch.bfloat16, torch.float32]
CASES = [(R, C, dt) for R in ROWS for C in WIDTHS for dt in DTYPES]
IDS = [f"R{R}-C{C}-{str(dt)[6:]}" for R, C, dt in CASES]


def _size(dt):
    return 2 if dt == torch.bfloat16 else 4


@pytest.mark.parametrize("R,C,dt", CASES, ids=IDS)
def test_plan_fits_and_covers_every_row_and_channel_once(R, C, dt):
    plan = t_ln.ln_plan(R, C, dt)
    row_bytes = C * _size(dt)
    assert plan.bulk  # every width on the paths is a whole number of 16-byte vectors
    # shared memory: the ring and its mbarriers, within one CTA's 227 KB and
    # small enough for the launch bound's two CTAs per SM
    assert plan.smem == plan.stages * plan.tile_rows * row_bytes + 8 * plan.stages
    assert plan.smem + 1024 <= t_ln.SM_SMEM // t_ln.LN_CTAS_PER_SM
    assert 1 <= plan.stages <= t_ln.LN_MAX_STAGES
    # lanes: a power-of-two group per row, each lane at most 32 values, the
    # vectors lig + group * i (i < vpl) cover the row's vectors once
    nvec = row_bytes // 16
    g = plan.group
    assert g & (g - 1) == 0 and 1 <= g <= 32
    assert plan.vpl * (16 // _size(dt)) <= t_ln.LN_MAX_VALUES
    lanes = np.zeros(nvec, np.int32)
    for lig in range(g):
        for i in range(plan.vpl):
            if lig + g * i < nvec:
                lanes[lig + g * i] += 1
    assert (lanes == 1).all()
    # a tile's rows in flight: every row of a tile once, every lane of a warp
    # the same number of iterations (full-warp shuffles)
    groups = t_ln.LN_THREADS // g
    assert plan.tile_rows % groups == 0
    # persistent CTAs: CTA c walks tiles c, c + grid, ...; every tile once,
    # every row once, no CTA without a tile, the ring no deeper than a
    # CTA's tiles
    assert plan.tiles == -(-R // plan.tile_rows)
    assert 1 <= plan.grid <= min(plan.tiles, t_ln.NUM_SMS * t_ln.LN_CTAS_PER_SM)
    seen = np.zeros(R, np.int32)
    per_cta = []
    for cta in range(plan.grid):
        tiles = range(cta, plan.tiles, plan.grid)
        per_cta.append(len(tiles))
        for t in tiles:
            seen[t * plan.tile_rows:(t + 1) * plan.tile_rows] += 1
    assert (seen == 1).all()
    assert min(per_cta) >= 1 and plan.stages <= max(per_cta)


@pytest.mark.parametrize("R,C,dt", [c for c in CASES if c[0] >= 20000], ids=[
    i for c, i in zip(CASES, IDS) if c[0] >= 20000])
def test_large_calls_fill_the_card_with_tiles_in_flight(R, C, dt):
    """The bytes-bound calls: every CTA slot of the card busy, several
    tiles per CTA, and tens of KB per SM in flight in the ring."""
    plan = t_ln.ln_plan(R, C, dt)
    assert plan.grid == t_ln.NUM_SMS * t_ln.LN_CTAS_PER_SM
    assert plan.stages >= 2
    ring_per_sm = t_ln.LN_CTAS_PER_SM * plan.stages * plan.tile_rows * C * _size(dt)
    assert ring_per_sm >= 32 * 1024


@pytest.mark.parametrize("C", [96, 768])
def test_a_call_of_a_few_rows_is_one_small_tile(C):
    """MViT's cls rows: one CTA, one buffer, the smallest tile (one row per
    lane group; the bulk copy moves only the rows there are)."""
    for R in (1, 2, 4):
        plan = t_ln.ln_plan(R, C, torch.bfloat16)
        assert (plan.grid, plan.tiles, plan.stages) == (1, 1, 1)
        assert plan.tile_rows == t_ln.LN_THREADS // plan.group


@pytest.mark.parametrize("C,dt", [(100, torch.bfloat16), (98, torch.float32),
                                  (7, torch.bfloat16), (1023, torch.float32)])
def test_rows_not_in_16_byte_vectors_take_the_row_kernel(C, dt):
    plan = t_ln.ln_plan(1000, C, dt)
    assert not plan.bulk and plan.tile_rows == 0
    assert plan.grid == -(-1000 // t_ln.LN_ROWS_PER_CTA)


@pytest.mark.parametrize("C", [96, 768])
def test_a_misaligned_input_takes_the_row_kernel(C):
    plan = t_ln.ln_plan(5000, C, torch.bfloat16, aligned=False)
    assert not plan.bulk and plan.tile_rows == 0 and plan.stages == 0


@pytest.mark.parametrize("R,C,dt", [(10, 0, torch.bfloat16), (10, 1025, torch.bfloat16),
                                    (10, 4096, torch.float32), (0, 96, torch.bfloat16),
                                    (10, 96, torch.float16), (10, 96, torch.float64)])
def test_plan_refuses_what_no_path_of_the_kernel_takes(R, C, dt):
    with pytest.raises(ValueError):
        t_ln.ln_plan(R, C, dt)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_plan_mirrors_the_kernel_source():
    """The constants the plan shares with csrc/layernorm.cu, the launch
    bound, the lane-group rule and the entry's trailing plan arguments."""
    src = CSRC.read_text()
    assert _constant(src, "THREADS") == t_ln.LN_THREADS
    assert _constant(src, "MAX_VALUES") == t_ln.LN_MAX_VALUES
    assert _constant(src, "MAX_C") == t_ln.MAX_C
    assert _constant(src, "MAX_STAGES") == t_ln.LN_MAX_STAGES
    assert _constant(src, "SMEM_MAX") == t_ln.SMEM_MAX
    assert _constant(src, "ROWS_PER_CTA") == t_ln.LN_ROWS_PER_CTA
    assert f"__launch_bounds__(THREADS, {t_ln.LN_CTAS_PER_SM})" in src
    assert "while (g * per_lane < nvec) g *= 2;" in src
    assert "(long long)stages * tile_rows * row_bytes + 8 * stages" in src
    sig = re.search(r'extern "C" int dsal_layernorm\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in sig.split(",")][-4:] == ["tile_rows", "stages", "grid",
                                                             "stream"]


def _entry_accepts(R, C, dt, plan, aligned=True):
    """The checks of the C entry `dsal_layernorm`, transcribed."""
    size = _size(dt)
    row_bytes = C * size
    if R < 1 or C < 1 or C > t_ln.MAX_C:
        return False
    bulk = row_bytes % 16 == 0 and aligned
    if not bulk:
        return plan.tile_rows == 0
    nvec, per_vec = row_bytes // 16, 16 // size
    g = 1
    while g * (t_ln.LN_MAX_VALUES // per_vec) < nvec:
        g *= 2
    smem = plan.stages * plan.tile_rows * row_bytes + 8 * plan.stages
    tiles = -(-R // plan.tile_rows) if plan.tile_rows > 0 else 0
    return (plan.tile_rows > 0 and plan.tile_rows % (t_ln.LN_THREADS // g) == 0
            and 1 <= plan.stages <= t_ln.LN_MAX_STAGES and smem <= t_ln.SMEM_MAX
            and 1 <= plan.grid <= tiles)


@pytest.mark.parametrize("dt", DTYPES)
def test_the_entry_takes_every_plan_and_refuses_a_mismatched_one(dt):
    for R in ROWS:
        for C in WIDTHS + [100, 8, 40]:
            for aligned in (True, False):
                plan = t_ln.ln_plan(R, C, dt, aligned)
                assert _entry_accepts(R, C, dt, plan, aligned), (R, C, aligned)
    good = t_ln.ln_plan(5000, 96, dt)
    # a bulk plan for a misaligned input, a ragged tile, too many stages
    assert not _entry_accepts(5000, 96, dt, good, aligned=False)
    odd = t_ln.LnPlan(True, good.group, good.vpl, good.tile_rows + 1, good.stages, 0,
                      good.tiles, good.grid)
    assert not _entry_accepts(5000, 96, dt, odd)
    deep = t_ln.LnPlan(True, good.group, good.vpl, good.tile_rows, 5, 0, good.tiles, good.grid)
    assert not _entry_accepts(5000, 96, dt, deep)
