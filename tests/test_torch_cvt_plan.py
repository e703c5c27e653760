"""The host-side plan of K7's bf16 kernel (`cvt_plan` in
`diff_sal_tpu_torch/ops/attention.py`): the geometry
`csrc/cvt_attention.cu` chooses, checked on the CPU at the decoder's four
stages (Bt = 10 frames at B = 2, two heads) and at S = 1, 18 (the shipped
config), 100 and 128 keys, and its refusals."""

import re
from pathlib import Path

import numpy as np
import pytest

from diff_sal_tpu_torch.ops import attention as t_attn

CSRC = Path(t_attn.__file__).resolve().parent.parent / "csrc" / "cvt_attention.cu"

STAGES = [(84, 768), (336, 384), (1344, 192), (5376, 96)]  # (L, C) per decoder stage
CASES = [(L, C, S) for L, C in STAGES for S in (1, 18, 100, 128)]
IDS = [f"L{L}-C{C}-S{S}" for L, C, S in CASES]
SM_SMEM = 233_472  # shared memory of one SM; each CTA also holds 1 KB


def _fits(chunks, sp):
    return any(t_attn.cvt_smem(chunks, sp, st) <= t_attn.SMEM_MAX for st in range(1, 5))


@pytest.mark.parametrize("L,C,S", CASES, ids=IDS)
def test_cvt_plan_fits_or_refuses(L, C, S):
    """A plan fits its CTAs per SM in shared memory, as the source lays it
    out; a refusal happens exactly where one head's k and v do not fit
    beside a tile (head_dim 384 at 100 and 128 keys: the kernel before
    this one refused those as well)."""
    hd = C // 2
    sp = 16 if S <= 16 else (32 if S <= 32 else (64 if S <= 64 else 128))
    if not _fits(-(-hd // 32), sp):
        with pytest.raises(ValueError, match="shared memory"):
            t_attn.cvt_plan(10, L, S, C, 2)
        assert hd == 384 and S >= 100
        return
    plan = t_attn.cvt_plan(10, L, S, C, 2)
    assert plan.sp == sp and plan.sp >= S and plan.sp % 16 == 0
    assert plan.smem == t_attn.cvt_smem(plan.chunks, plan.sp, plan.stages) <= t_attn.SMEM_MAX
    assert plan.per_sm * (plan.smem + 1024) <= SM_SMEM
    assert 1 <= plan.stages <= 4 and (plan.per_sm == 1 or plan.stages >= 2)
    assert plan.groups in (1, 2) and plan.chunks * 32 >= C // plan.groups
    assert plan.head_ways == min(2, 2 // plan.groups)
    assert plan.threads == 32 * (4 * plan.head_ways + 1)
    if S == 18:  # the shipped config: whole rows where the tiles fill the card,
        # one head per CTA at the two coarsest stages (20 and 60 tiles of whole rows)
        assert plan.groups == (1 if C <= 192 else 2)


@pytest.mark.parametrize("L,C,S", [c for c in CASES if not (c[1] == 768 and c[2] >= 100)],
                         ids=[i for c, i in zip(CASES, IDS) if not (c[1] == 768 and c[2] >= 100)])
def test_cvt_tiles_cover_every_row_once(L, C, S):
    """The CTAs' contiguous tile ranges (the kernel's split of the tiles)
    cover every (batch item, head group, row) once; no CTA is empty; each
    CTA reloads k and v at most once per batch item (and group) it enters."""
    Bt = 10
    plan = t_attn.cvt_plan(Bt, L, S, C, 2)
    assert plan.row_tiles == -(-L // 64) and plan.tiles == Bt * plan.groups * plan.row_tiles
    assert plan.ctas == min(plan.tiles, plan.per_sm * 132)
    seen = np.zeros((Bt, plan.groups, plan.row_tiles * 64), np.int32)
    for c in range(plan.ctas):
        t0, t1 = c * plan.tiles // plan.ctas, (c + 1) * plan.tiles // plan.ctas
        assert t1 > t0
        kv = []
        for tile in range(t0, t1):
            rt, bg = tile % plan.row_tiles, tile // plan.row_tiles
            seen[bg // plan.groups, bg % plan.groups, rt * 64:(rt + 1) * 64] += 1
            if not kv or kv[-1] != bg:
                kv.append(bg)
        assert len(kv) == len(set(kv))
    assert (seen == 1).all()


def test_cvt_plan_takes_the_card_path_shapes_with_two_ctas_per_sm_where_rows_are_many():
    """The finest stages (most of the bytes) keep two CTAs per SM with a
    ring of at least two tiles each and two warps per 16 rows (a head each);
    the coarsest, with fewer tiles of whole rows than SMs, split the heads
    over CTAs instead."""
    for L, C in ((5376, 96), (1344, 192)):
        plan = t_attn.cvt_plan(10, L, 18, C, 2)
        assert plan.per_sm == 2 and plan.stages >= 2 and plan.head_ways == 2
    for L, C in ((84, 768), (336, 384)):
        plan = t_attn.cvt_plan(10, L, 18, C, 2)
        assert plan.groups == 2 and plan.head_ways == 1 and plan.tiles == 2 * 10 * -(-L // 64)
        assert 10 * -(-L // 64) < 132


@pytest.mark.parametrize("C,heads", [(72, 3), (40, 2), (100, 2), (96, 0)])
def test_cvt_plan_refuses_head_dims_not_a_multiple_of_16(C, heads):
    with pytest.raises(ValueError, match="multiple of 16"):
        t_attn.cvt_plan(2, 50, 18, C, heads)


@pytest.mark.parametrize("S", [0, 129, 200])
def test_cvt_plan_refuses_key_counts_outside_1_to_128(S):
    with pytest.raises(ValueError, match="keys"):
        t_attn.cvt_plan(2, 50, S, 96, 2)


def test_cvt_plan_splits_heads_where_whole_rows_do_not_fit():
    """64 keys at head_dim 384 (a card test's shape): whole rows' k and v do
    not fit beside a tile, one head's do; a group of one head of 48 columns
    is not whole 32-column boxes, so three heads of 48 stay together."""
    plan = t_attn.cvt_plan(2, 77, 64, 768, 2)
    assert plan.groups == 2 and plan.chunks == 12
    assert t_attn.cvt_plan(2, 130, 33, 144, 3).groups == 1


def test_cvt_plan_mirrors_the_kernel_source():
    """What the plan shares with csrc/cvt_attention.cu: the limits, the
    shared-memory layout, the order of the choices and the entry's
    signature (the plan is chosen inside the entry)."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert consts["SMEM_MAX"] == str(t_attn.SMEM_MAX)
    assert consts["SMEM_TWO"] == str(t_attn.CVT_SMEM_TWO)
    assert consts["MAX_S"] == str(t_attn.CVT_MAX_S)
    assert consts["MAX_STAGES"] == str(t_attn.CVT_MAX_STAGES)
    assert consts["NUM_SMS"] == str(t_attn.NUM_SMS)
    assert "constexpr int TR = 16 * WARPS;" in src and consts["WARPS"] == "4"
    assert t_attn.CVT_ROWS == 64
    assert ("return stages * chunks * TR * 64 + 2 * chunks * sp * 64 + (2 * stages + 1) * 8 + "
            "1024;") in src
    assert "if (heads % g != 0 || (g > 1 && heads / g * hd % 32 != 0)) continue;" in src
    assert "if (Bt * g * rtiles >= NUM_SMS) break;" in src
    assert "const int ways = hg >= 2 ? 2 : 1;" in src
    assert "__launch_bounds__(32 * (4 * HW + 1))" in src
    assert "for (int stages = MAX_STAGES; stages >= 2; --stages)" in src
    assert "for (int stages = MAX_STAGES; stages >= 1; --stages)" in src
    assert "while (sp < S) sp *= 2;" in src
    sig = re.search(r'extern "C" int dsal_cvt_attention\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in sig.split(",")] == ["q", "k", "v", "out", "Bt", "L", "S", "C",
                                                       "heads", "scale", "stream"]


# ------------------------------------------------------ the f32 instance ---

F32_CASES = CASES + [(201, 2 * hd, S) for hd in (32, 48, 384) for S in (1, 18, 64, 100, 128)]
F32_IDS = [f"L{L}-C{C}-S{S}" for L, C, S in F32_CASES]


def _fits_f32(chunks, sp, tr):
    return t_attn.cvt_f32_smem(chunks, sp, tr, 1) <= t_attn.SMEM_MAX


@pytest.mark.parametrize("L,C,S", F32_CASES, ids=F32_IDS)
def test_cvt_f32_plan_fits_or_refuses(L, C, S):
    """A plan fits its CTAs per SM in shared memory, as the source lays it
    out, with the largest tile (64, 32 or 16 rows) that fits one head's k
    and v beside it; a refusal happens exactly where one head's k and v do
    not fit beside a 16-row tile (head_dim 384 at more than 64 keys)."""
    hd = C // 2
    sp = 8
    while sp < S:
        sp *= 2
    chunks = -(-hd // 32)
    if not _fits_f32(chunks, sp, 16):
        with pytest.raises(ValueError, match="shared memory"):
            t_attn.cvt_f32_plan(10, L, S, C, 2)
        assert hd == 384 and S > 64
        return
    plan = t_attn.cvt_f32_plan(10, L, S, C, 2)
    assert plan.sp == sp >= S
    assert plan.tile_rows == next(tr for tr in (64, 32, 16) if _fits_f32(chunks, sp, tr))
    assert plan.smem == t_attn.cvt_f32_smem(plan.chunks, plan.sp, plan.tile_rows, plan.stages)
    assert plan.smem <= t_attn.SMEM_MAX and plan.per_sm * (plan.smem + 1024) <= SM_SMEM
    assert 1 <= plan.stages <= 4 and (plan.per_sm == 1 or plan.stages >= 2)
    assert plan.groups in (1, 2) and plan.chunks * 32 >= C // plan.groups
    assert plan.head_ways == min(2, 2 // plan.groups)
    assert plan.threads == 32 * (plan.tile_rows // 16 * plan.head_ways + 1) <= 288


@pytest.mark.parametrize("L,C,S", [c for c in F32_CASES if not (c[1] == 768 and c[2] > 64)],
                         ids=[i for c, i in zip(F32_CASES, F32_IDS)
                              if not (c[1] == 768 and c[2] > 64)])
def test_cvt_f32_tiles_cover_every_row_once(L, C, S):
    """The CTAs' contiguous tile ranges cover every (batch item, head group,
    row) once; no CTA is empty; each CTA reloads k and v at most once per
    batch item (and group) it enters."""
    Bt = 10
    plan = t_attn.cvt_f32_plan(Bt, L, S, C, 2)
    tr = plan.tile_rows
    assert plan.row_tiles == -(-L // tr) and plan.tiles == Bt * plan.groups * plan.row_tiles
    assert plan.ctas == min(plan.tiles, plan.per_sm * 132)
    seen = np.zeros((Bt, plan.groups, plan.row_tiles * tr), np.int32)
    for c in range(plan.ctas):
        t0, t1 = c * plan.tiles // plan.ctas, (c + 1) * plan.tiles // plan.ctas
        assert t1 > t0
        kv = []
        for tile in range(t0, t1):
            rt, bg = tile % plan.row_tiles, tile // plan.row_tiles
            seen[bg // plan.groups, bg % plan.groups, rt * tr:(rt + 1) * tr] += 1
            if not kv or kv[-1] != bg:
                kv.append(bg)
        assert len(kv) == len(set(kv))
    assert (seen == 1).all()


@pytest.mark.parametrize("hd", [8, 24, 32, 40, 48, 56, 96, 192, 384])
def test_cvt_f32_plan_takes_every_head_dim_the_old_instance_took(hd):
    """Head_dims that are a multiple of 8, from 8 to 384 (an odd number of
    8-column groups among them), at 1-128 keys: what the FFMA instance took
    there (one head's k and v and 32 query rows within a CTA) is taken. It
    also took head_dims that are not a multiple of 8; those are refused now
    (the test below)."""
    for S in (1, 18, 33, 59, 64, 100, 128):
        old = (32 * hd + 2 * S * (hd + 1)) * 4 <= t_attn.SMEM_MAX
        try:
            t_attn.cvt_f32_plan(2, 130, S, 2 * hd, 2)
        except ValueError:
            assert not old, (hd, S)


@pytest.mark.parametrize("C,heads", [(36, 3), (40, 2), (100, 2), (96, 0)])
def test_cvt_f32_plan_refuses_head_dims_not_a_multiple_of_8(C, heads):
    with pytest.raises(ValueError, match="multiple of 8"):
        t_attn.cvt_f32_plan(2, 50, 18, C, heads)


@pytest.mark.parametrize("S", [0, 129, 200])
def test_cvt_f32_plan_refuses_key_counts_outside_1_to_128(S):
    with pytest.raises(ValueError, match="keys"):
        t_attn.cvt_f32_plan(2, 50, S, 96, 2)


def test_cvt_f32_plan_streams_the_finest_stage_two_ctas_per_sm():
    """The finest stage (most of the bytes): whole rows, two CTAs per SM
    with three buffers each, two warps per 16 rows; the coarsest split the
    heads over CTAs."""
    plan = t_attn.cvt_f32_plan(10, 5376, 18, 96, 2)
    assert (plan.groups, plan.per_sm, plan.stages, plan.head_ways) == (1, 2, 3, 2)
    for L, C in ((84, 768), (336, 384)):
        assert t_attn.cvt_f32_plan(10, L, 18, C, 2).groups == 2


def test_cvt_f32_plan_mirrors_the_kernel_source():
    """What `cvt_f32_plan` shares with csrc/cvt_attention.cu: the
    shared-memory layout, the order of the choices, the tensor maps' f32
    boxes (128-byte swizzle, `make_map` in hopper.cuh), and the entry's
    signature."""
    src = CSRC.read_text()
    assert ("return stages * chunks * tr * 128 + 2 * sp * (32 * chunks + 4) * 4 + 2 * stages * 8 "
            "+ 1024;") in src
    assert "for (int tr = 64; tr >= 16; tr /= 2) {" in src
    assert "hd < 8 || hd % 8 != 0 || hd * heads != C" in src
    assert "int sp = 8;\n  while (sp < S) sp *= 2;" in src
    assert "if (cvt_f32_smem((heads / g * hd + 31) / 32, sp, tr, 1) > SMEM_MAX) continue;" in src
    assert "if (cvt_f32_smem(chunks, sp, tr, stages) <= SMEM_TWO) {" in src
    hopper = (CSRC.parent / "hopper.cuh").read_text()
    assert "F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in hopper
    assert "F32 ? CU_TENSOR_MAP_SWIZZLE_128B" in hopper
    assert "make_map(&tq, q, Bt, L, C, plan.tr, true)" in src
    assert "constexpr int F32_MAX_THREADS = 32 * (4 * 2 + 1);" in src
    assert "cvt_attn_f32_kernel<SP><<<grid, 32 * (p.tr / 16 * p.ways + 1), smem, s>>>" in src
    sig = re.search(r'extern "C" int dsal_cvt_attention_f32\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in sig.split(",")] == ["q", "k", "v", "out", "Bt", "L", "S", "C",
                                                       "heads", "scale", "stream"]
