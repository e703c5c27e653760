"""The host-side plan of the K1 / K12 forward kernel (`fwd_plan` in
`diff_sal_tpu_torch/ops/attention.py`): the geometry `csrc/attention.cu`
launches with, checked on the CPU at MViTv2-small's seven block shapes
(224x384x16), in both layouts (K1: B batches of H heads; K12: B*H batches
of one head with the cls row added to the queries), at B = 2 and 4."""

import re
from pathlib import Path

import numpy as np
import pytest

from diff_sal_tpu_torch.ops import attention as t_attn

CSRC = Path(t_attn.__file__).resolve().parent.parent / "csrc" / "attention.cu"

# (heads, Lq of K1, key grid) of the sixteen blocks; head_dim 96 throughout
MVIT_BLOCKS = [(1, 43008, (8, 7, 12)), (2, 10752, (8, 14, 24)), (2, 10752, (8, 7, 12)),
               (4, 2688, (8, 14, 24)), (4, 2688, (8, 7, 12)), (8, 672, (8, 14, 24)),
               (8, 672, (8, 7, 12))]
CASES = [(B, layout, H, Lq, ks) for B in (2, 4) for layout in ("k1", "k12")
         for H, Lq, ks in MVIT_BLOCKS]
IDS = [f"B{B}-{layout}-H{H}-Lq{Lq}-kh{ks[1]}" for B, layout, H, Lq, ks in CASES]


def _launch(B, layout, H, Lq, ks, D=96):
    """(batches, heads, Lq, Lk, plan) as the wrapper of that layout calls it."""
    Lk = 1 + ks[0] * ks[1] * ks[2]
    if layout == "k12":
        B, H, Lq = B * H, 1, Lq + 1
    return B, H, Lq, Lk, t_attn.fwd_plan(B, H, Lq, Lk, D, ks)


@pytest.mark.parametrize("B,layout,H,Lq,ks", CASES, ids=IDS)
def test_grid_covers_every_query_row_once(B, layout, H, Lq, ks):
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks)
    assert plan.ctas == B * H * plan.q_tiles and plan.rows in (64, 128)
    seen = np.zeros((B * H, Lq), np.int32)
    for cta in range(plan.ctas):  # the kernel's decomposition of blockIdx.x
        bh, tile = divmod(cta, plan.q_tiles)
        seen[bh, tile * plan.rows:(tile + 1) * plan.rows] += 1
    assert (seen == 1).all()
    # no CTA is empty: the last tile starts inside the rows
    assert (plan.q_tiles - 1) * plan.rows < Lq <= plan.q_tiles * plan.rows


@pytest.mark.parametrize("B,layout,H,Lq,ks", CASES, ids=IDS)
def test_shared_memory_fits_a_cta(B, layout, H, Lq, ks):
    *_, Lk, plan = _launch(B, layout, H, Lq, ks)
    assert plan.smem <= 232_448
    assert plan.smem == t_attn.fwd_smem(96, plan.rows, plan.block_n, plan.stages, Lk, ks)
    assert 2 <= plan.stages <= 4 and plan.block_n in (64, 128)


@pytest.mark.parametrize("B,layout,H,Lq,ks", CASES, ids=IDS)
def test_tma_strides_and_boxes(B, layout, H, Lq, ks):
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks)
    assert [m[0] for m in plan.tma] == ["q", "k", "v"]
    for name, dims, strides, box in plan.tma:
        assert dims == (H * 96, Lq if name == "q" else Lk, B)
        assert all(s % 16 == 0 for s in strides), (name, strides)
        assert box[0] * 2 % 16 == 0 and box[0] * 2 <= 64  # inner box within the 64-byte swizzle
        assert all(1 <= n <= 256 for n in box), (name, box)
        assert box[1] == (plan.rows if name == "q" else plan.block_n)


@pytest.mark.parametrize("B,layout,H,Lq,ks", CASES, ids=IDS)
def test_cta_count_fills_the_card(B, layout, H, Lq, ks):
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks)
    most = B * H * -(-Lq // 64)
    assert plan.ctas >= 132 or plan.ctas == most


@pytest.mark.parametrize("D", [32, 48, 80, 160, 256])
def test_plan_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head_dim"):
        t_attn.fwd_plan(2, 1, 100, 673, D, (8, 7, 12))


@pytest.mark.parametrize("ks", [(100, 100, 57), (1, 1, t_attn.MAX_REL)])
def test_plan_refuses_key_grids_past_max_rel(ks):
    Lk = 1 + ks[0] * ks[1] * ks[2]
    with pytest.raises(ValueError, match="kt\\+kh\\+kw"):
        t_attn.fwd_plan(2, 1, 100, Lk, 96, ks)


def test_plan_refuses_a_key_grid_beyond_shared_memory():
    # kt*kh entries per bias row: 128 rows x ~60k floats cannot fit
    with pytest.raises(ValueError, match="shared memory"):
        t_attn.fwd_plan(2, 1, 100, 1 + 120 * 120 * 2, 96, (120, 120, 2))


@pytest.mark.parametrize("D", [64, 96, 128])
def test_plan_takes_the_other_head_dims_at_the_largest_block(D):
    plan = t_attn.fwd_plan(2, 2, 10752, 2689, D, (8, 14, 24))
    assert plan.smem <= 232_448 and plan.ctas >= 132


def test_plan_mirrors_the_kernel_source():
    """What the plan shares with csrc/attention.cu: the shared-memory limit,
    the keys per tile that the source derives from the rows per CTA, and the
    entry points' trailing (rows, stages, stream) arguments."""
    src = CSRC.read_text()
    assert re.search(r"constexpr int SMEM_MAX = (\d+);", src).group(1) == str(t_attn.SMEM_MAX)
    assert "bn = rows == 128 ? 64 : 128" in src
    for rows, bn in ((128, 64), (64, 128)):
        B = 132 if rows == 128 else 1
        assert t_attn.fwd_plan(B, 1, 128, 673, 96, (8, 7, 12)).block_n == bn
    for entry in ("dsal_bias_attention", "dsal_cls_attention"):
        sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
        assert [a.split()[-1] for a in sig.split(",")][-3:] == ["rows", "stages", "stream"]
