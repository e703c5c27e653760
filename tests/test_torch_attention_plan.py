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


# ---------------------------------------------------------------- backward ---

BWD_CSRC = CSRC.parent / "attention_bwd.cu"
BWD_CASES = [(B, layout, H, Lq, ks, D) for B, layout, H, Lq, ks in CASES for D in (64, 96, 128)]
BWD_IDS = [f"{i}-D{D}" for i, (*_, D) in zip([i for i in IDS for _ in range(3)], BWD_CASES)]


def _bwd_launch(B, layout, H, Lq, ks, D):
    """(batches, heads, Lq, Lk, plan) as the backward wrapper of that layout
    calls it."""
    Lk = 1 + ks[0] * ks[1] * ks[2]
    if layout == "k12":
        B, H, Lq = B * H, 1, Lq + 1
    return B, H, Lq, Lk, t_attn.bwd_plan(B, H, Lq, Lk, D, ks)


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", BWD_CASES, ids=BWD_IDS)
def test_bwd_plan_fits_a_cta(B, layout, H, Lq, ks, D):
    """Both backward kernels' shared memory fits one CTA (227 KB), as the
    source lays it out, with the launch bound's 128 threads; at MViT's
    head_dim 96 two CTAs fit on an SM."""
    *_, Lk, plan = _bwd_launch(B, layout, H, Lq, ks, D)
    assert (plan.smem_q, plan.smem_k) == t_attn.bwd_smem(D, sum(ks))
    assert max(plan.smem_q, plan.smem_k) <= 232_448
    assert plan.threads == 128 and plan.rows == plan.block_n == 64 and plan.stages == 2
    assert plan.bins >= sum(ks) and plan.bins % 16 == 0
    assert plan.relp_cols >= sum(ks) + 4 and plan.relp_cols % 4 == 0
    if D == 96:  # two CTAs per SM: 228 KB less 1 KB reserved per CTA
        assert max(plan.smem_q, plan.smem_k) + 1024 <= 233_472 // 2


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", BWD_CASES, ids=BWD_IDS)
def test_bwd_grids_cover_every_row_and_key(B, layout, H, Lq, ks, D):
    """The q-major grid covers every query row once; the k-major grid every
    key once per split, and the splits (as `bwd_splits` gives them) every
    query tile once."""
    B, H, Lq, Lk, plan = _bwd_launch(B, layout, H, Lq, ks, D)
    q_tiles = -(-Lq // plan.rows)
    assert plan.q_ctas == B * H * q_tiles and (q_tiles - 1) * plan.rows < Lq
    assert plan.ntiles == -(-Lk // plan.block_n) and (plan.ntiles - 1) * 64 < Lk
    assert plan.splits == t_attn.bwd_splits(B, H, Lq, Lk)
    assert plan.k_ctas == B * H * plan.ntiles * plan.splits
    n_qt = -(-Lq // plan.block_n)
    per = -(-n_qt // plan.splits)  # the kernel's split of the query tiles
    seen = np.zeros(n_qt, np.int32)
    for split in range(plan.splits):
        seen[split * per:min(n_qt, (split + 1) * per)] += 1
    assert (seen == 1).all()
    # enough CTAs for the card, unless every split already holds one tile
    assert plan.k_ctas >= 132 or plan.splits == n_qt


@pytest.mark.parametrize("D,ks", [(80, (8, 7, 12)), (96, (60, 40, 29)), (64, (0, 0, 0))])
def test_bwd_plan_refuses_what_the_kernels_do_not_take(D, ks):
    with pytest.raises(ValueError):
        t_attn.bwd_plan(2, 1, 100, 1 + max(1, ks[0] * ks[1] * ks[2]), D, ks)


def test_bwd_plan_mirrors_the_kernel_source():
    """What the plan shares with csrc/attention_bwd.cu: the shared-memory
    limit, the tile, the stages, the threads per CTA and the padding of the
    bias bins and relp rows."""
    src = BWD_CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert consts["SMEM_MAX"] == str(t_attn.SMEM_MAX)
    assert consts["BM"] == consts["BN"] == str(t_attn.BWD_BLOCK)
    assert consts["STAGES"] == str(t_attn.BWD_STAGES)
    assert consts["NTHREADS"] == str(t_attn.BWD_THREADS)
    assert "return K <= 32 ? 32 : (K <= 48 ? 48 : 128);" in src
    assert "return (K + 4 + 3) / 4 * 4;" in src and "return (K + 4) | 1;" in src
    for K, bins, cols in ((8, 32, 12), (27, 32, 32), (46, 48, 52), (49, 128, 56),
                          (128, 128, 132)):
        plan = t_attn.bwd_plan(2, 1, 100, 1 + (K - 2), 96, (K - 2, 1, 1))
        assert (plan.bins, plan.relp_cols) == (bins, cols)
