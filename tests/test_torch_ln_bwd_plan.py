"""The host-side plan of the K6 LayerNorm backward kernel (`ln_bwd_plan` in
`diff_sal_tpu_torch/ops/layernorm.py`): the geometry
`csrc/layernorm_bwd.cu` launches with, checked on the CPU over the (rows,
C) the training paths produce (MViTv2-small's widths 96-768 on the spatial
rows and the 1-4 cls rows, its per-head norms, the decoder's 96-768) and
up to MAX_C = 1024, in bf16 and f32: that a CTA's ring (x and g tiles) and
the warps' sums fit in shared memory, that the persistent CTAs, the row
groups and the lanes cover every row and channel exactly once, that the
reduction kernel adds every CTA's partial row exactly once, and that the
plan agrees with the constants and checks of the CUDA source."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diff_sal_tpu_torch.ops import layernorm as t_ln

CSRC = Path(t_ln.__file__).resolve().parent.parent / "csrc" / "layernorm_bwd.cu"

# rows per call on the training paths at B = 1, 2 and 4: cls rows (B), the
# four MViT stages' token grids and the decoder's (43008 / 10752 / 2688 /
# 672 per clip), with the cls row, per-head norms, and ragged counts
# against every tile size
ROWS = [1, 2, 3, 4, 7, 64, 100, 257, 673, 1344, 2689, 5376, 10753, 21504, 43009, 86016,
        172036]
WIDTHS = [96, 192, 384, 512, 768, 1024]
DTYPES = [torch.bfloat16, torch.float32]
CASES = [(R, C, dt) for R in ROWS for C in WIDTHS for dt in DTYPES]
IDS = [f"R{R}-C{C}-{str(dt)[6:]}" for R, C, dt in CASES]


def _size(dt):
    return 2 if dt == torch.bfloat16 else 4


def _reduction_covers_every_cta_once(plan, C):
    """`layernorm_bwd_reduce_kernel` (grid > 1): CTA b takes columns
    [32 b, 32 b + 32) of the (grid, 2C) partial rows, warp w rows
    [RED_ROWS w, + RED_ROWS). Every (row, column) once."""
    if plan.grid == 1:
        return True
    red_rows = -(-t_ln.BWD_MAX_GRID // t_ln.BWD_WARPS)
    seen = np.zeros((plan.grid, 2 * C), np.int32)
    for b in range(-(-2 * C // 32)):
        for w in range(t_ln.BWD_WARPS):
            seen[red_rows * w:red_rows * (w + 1), 32 * b:32 * b + 32] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("R,C,dt", CASES, ids=IDS)
def test_plan_fits_and_covers_every_row_and_channel_once(R, C, dt):
    plan = t_ln.ln_bwd_plan(R, C, dt)
    row_bytes = C * _size(dt)
    assert plan.bulk  # every width on the paths is a whole number of 16-byte vectors
    # shared memory: the ring (an x and a g tile per stage) or the warps'
    # sums, then the mbarriers; two CTAs per SM (the launch bound)
    ring = 2 * plan.stages * plan.tile_rows * row_bytes
    assert plan.smem == max(ring, t_ln.bwd_red_bytes(C)) + 8 * plan.stages
    assert plan.smem + 1024 <= t_ln.SM_SMEM // t_ln.LN_CTAS_PER_SM
    assert 1 <= plan.stages <= t_ln.LN_MAX_STAGES
    # lanes: a power-of-two group per row, each lane at most 32 values of a
    # row, the vectors lig + group * i (i < vpl) cover the row once
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
    # the warps' sums: lanes lig < group of each warp write the channels of
    # their vectors; together every channel of the (2C,) row once per warp
    assert t_ln.LN_THREADS // 32 == t_ln.BWD_WARPS
    # rows of a tile in flight: every lane of a warp the same iterations
    groups = t_ln.LN_THREADS // g
    assert plan.tile_rows % groups == 0
    # persistent CTAs: CTA c walks tiles c, c + grid, ...; every row once
    assert plan.tiles == -(-R // plan.tile_rows)
    assert 1 <= plan.grid <= min(plan.tiles, t_ln.BWD_MAX_GRID)
    seen = np.zeros(R, np.int32)
    per_cta = []
    for cta in range(plan.grid):
        tiles = range(cta, plan.tiles, plan.grid)
        per_cta.append(len(tiles))
        for t in tiles:
            seen[t * plan.tile_rows:(t + 1) * plan.tile_rows] += 1
    assert (seen == 1).all()
    assert min(per_cta) >= 1 and plan.stages <= max(per_cta)
    assert _reduction_covers_every_cta_once(plan, C)


@pytest.mark.parametrize("R,C,dt", [c for c in CASES if c[0] >= 20000], ids=[
    i for c, i in zip(CASES, IDS) if c[0] >= 20000])
def test_large_calls_fill_the_card_with_tiles_in_flight(R, C, dt):
    """The bytes-bound calls: every CTA slot busy, several tiles per CTA,
    tens of KB of x and g per SM in flight."""
    plan = t_ln.ln_bwd_plan(R, C, dt)
    assert plan.grid == t_ln.BWD_MAX_GRID
    assert plan.stages >= 1
    ring_per_sm = t_ln.LN_CTAS_PER_SM * 2 * plan.stages * plan.tile_rows * C * _size(dt)
    assert ring_per_sm >= 32 * 1024


@pytest.mark.parametrize("C", [96, 384, 768])
@pytest.mark.parametrize("dt", DTYPES)
def test_a_call_of_a_few_rows_is_one_cta_without_partial_rows(C, dt):
    """MViT's cls rows: one CTA, one buffer, one tile (the bulk copies move
    only the rows there are); the CTA writes d_weight and d_bias itself."""
    for R in (1, 2, 4):
        plan = t_ln.ln_bwd_plan(R, C, dt)
        assert (plan.grid, plan.tiles, plan.stages) == (1, 1, 1)
        assert plan.tile_rows == t_ln.LN_THREADS // plan.group


@pytest.mark.parametrize("C,dt", [(100, torch.bfloat16), (98, torch.float32),
                                  (7, torch.bfloat16), (1023, torch.float32)])
def test_rows_not_in_16_byte_vectors_take_the_row_kernel(C, dt):
    for R in (1, 1000, 100_000):
        plan = t_ln.ln_bwd_plan(R, C, dt)
        assert not plan.bulk and plan.tile_rows == 0 and plan.stages == 0
        assert plan.grid == min(-(-R // t_ln.LN_ROWS_PER_CTA), t_ln.BWD_MAX_GRID)
        assert plan.smem == t_ln.bwd_red_bytes(C) <= t_ln.SMEM_MAX
        assert _reduction_covers_every_cta_once(plan, C)


@pytest.mark.parametrize("C", [96, 768])
def test_a_misaligned_input_takes_the_row_kernel(C):
    plan = t_ln.ln_bwd_plan(5000, C, torch.bfloat16, aligned=False)
    assert not plan.bulk and plan.tile_rows == 0 and plan.stages == 0


@pytest.mark.parametrize("R,C,dt", [(10, 0, torch.bfloat16), (10, 1025, torch.bfloat16),
                                    (10, 4096, torch.float32), (0, 96, torch.bfloat16),
                                    (10, 96, torch.float16), (10, 96, torch.float64)])
def test_plan_refuses_what_no_path_of_the_kernel_takes(R, C, dt):
    with pytest.raises(ValueError):
        t_ln.ln_bwd_plan(R, C, dt)


def _constant(src, name):
    """`constexpr int NAME = a * b ...;` of the source, as a number."""
    expr = re.search(rf"constexpr int {name} = ([\d *]+);", src).group(1)
    return int(np.prod([int(t) for t in expr.split("*")]))


def test_plan_mirrors_the_kernel_source():
    """The constants the plan shares with csrc/layernorm_bwd.cu, the launch
    bound, the lane-group rule, the shared-memory rule and the entry's
    trailing plan arguments."""
    src = CSRC.read_text()
    assert _constant(src, "THREADS") == t_ln.LN_THREADS
    assert _constant(src, "MAX_VALUES") == t_ln.LN_MAX_VALUES
    assert _constant(src, "MAX_C") == t_ln.MAX_C
    assert _constant(src, "MAX_STAGES") == t_ln.LN_MAX_STAGES
    assert _constant(src, "MAX_GRID") == t_ln.BWD_MAX_GRID
    assert "constexpr int RED_ROWS = (MAX_GRID + WARPS - 1) / WARPS;" in src
    assert _constant(src, "SMEM_MAX") == t_ln.SMEM_MAX
    assert _constant(src, "ROWS_PER_CTA") == t_ln.LN_ROWS_PER_CTA
    assert f"__launch_bounds__(THREADS, {t_ln.LN_CTAS_PER_SM})" in src
    assert "while (g * per_lane < nvec) g *= 2;" in src
    assert "return 4LL * WARPS * 2 * C; }" in src
    assert "const long long ring = 2LL * stages * tile_rows * row_bytes;" in src
    assert "(ring > red_bytes(C) ? ring : red_bytes(C)) + 8LL * stages" in src
    sig = re.search(r'extern "C" int dsal_layernorm_bwd\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in sig.split(",")][-4:] == ["tile_rows", "stages", "grid",
                                                             "stream"]
    assert len(sig.split(",")) == len(t_ln.BWD_KERNEL.argtypes)


def _entry_accepts(R, C, dt, plan, aligned=True, part=None):
    """The checks of the C entry `dsal_layernorm_bwd`, transcribed."""
    size = _size(dt)
    row_bytes = C * size
    part = plan.grid > 1 if part is None else part  # the wrapper's partial rows
    if R < 1 or C < 1 or C > t_ln.MAX_C:
        return False
    if plan.grid < 1 or plan.grid > t_ln.BWD_MAX_GRID or (plan.grid > 1) != part:
        return False
    bulk = row_bytes % 16 == 0 and aligned
    if not bulk:
        return plan.tile_rows == 0 and plan.grid <= -(-R // t_ln.LN_ROWS_PER_CTA)
    nvec, per_vec = row_bytes // 16, 16 // size
    g = 1
    while g * (t_ln.LN_MAX_VALUES // per_vec) < nvec:
        g *= 2
    ring = 2 * plan.stages * plan.tile_rows * row_bytes
    smem = max(ring, t_ln.bwd_red_bytes(C)) + 8 * plan.stages
    tiles = -(-R // plan.tile_rows) if plan.tile_rows > 0 else 0
    return (plan.tile_rows > 0 and plan.tile_rows % (t_ln.LN_THREADS // g) == 0
            and 1 <= plan.stages <= t_ln.LN_MAX_STAGES and smem <= t_ln.SMEM_MAX
            and plan.grid <= tiles)


@pytest.mark.parametrize("dt", DTYPES)
def test_the_entry_takes_every_plan_and_refuses_a_mismatched_one(dt):
    for R in ROWS:
        for C in WIDTHS + [100, 8, 40]:
            for aligned in (True, False):
                plan = t_ln.ln_bwd_plan(R, C, dt, aligned)
                assert _entry_accepts(R, C, dt, plan, aligned), (R, C, aligned)
    good = t_ln.ln_bwd_plan(50_000, 96, dt)
    fields = {f: getattr(good, f) for f in good.__dataclass_fields__}

    def bad(**kw):
        return not _entry_accepts(50_000, 96, dt, t_ln.LnBwdPlan(**{**fields, **kw}))
    # a bulk plan for a misaligned input, a ragged tile, too many stages, a
    # grid past the card's slots, no partial rows for a grid of many
    assert not _entry_accepts(50_000, 96, dt, good, aligned=False)
    assert bad(tile_rows=good.tile_rows + 1)
    assert bad(stages=5)
    assert bad(grid=t_ln.BWD_MAX_GRID + 1)
    assert not _entry_accepts(50_000, 96, dt, good, part=False)
