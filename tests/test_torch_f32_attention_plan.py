"""The host-side plan of the f32 attention forward (`f32_fwd_plan` in
`diff_sal_tpu_torch/ops/attention.py`): the geometry
`csrc/attention_f32_fwd.cu` chooses for K1 and K12 in f32, checked on the
CPU at the shapes the paths send: MViTv2-small's seven block shapes
(224x384x16) in both layouts at B = 2 and 4, and the small models of
`chip_smoke.py`'s f32 phase (MViT tiny at 128x96), at every head_dim the
kernel takes."""

import re
from pathlib import Path

import numpy as np
import pytest

from diff_sal_tpu_torch.ops import attention as t_attn
from test_torch_attention_plan import MVIT_BLOCKS

CSRC = Path(t_attn.__file__).resolve().parent.parent / "csrc" / "attention_f32_fwd.cu"

# (heads, Lq of K1, key grid) of MViT tiny at 128x96 (phase 10's K1 calls)
TINY_BLOCKS = [(1, 6144, (8, 4, 3)), (2, 1536, (8, 4, 3)), (2, 1536, (8, 8, 6)),
               (4, 384, (8, 4, 3)), (4, 384, (8, 8, 6)), (8, 96, (8, 4, 3)), (8, 96, (8, 8, 6))]
CASES = [(B, layout, H, Lq, ks, D) for B in (2, 4) for layout in ("k1", "k12")
         for H, Lq, ks in MVIT_BLOCKS + TINY_BLOCKS for D in t_attn.HEAD_DIMS]
IDS = [f"B{B}-{layout}-H{H}-Lq{Lq}-kh{ks[1]}-D{D}" for B, layout, H, Lq, ks, D in CASES]


def _launch(B, layout, H, Lq, ks, D):
    """(batches, heads, Lq, Lk, plan) as the wrapper of that layout calls it."""
    Lk = 1 + ks[0] * ks[1] * ks[2]
    if layout == "k12":
        B, H, Lq = B * H, 1, Lq + 1
    return B, H, Lq, Lk, t_attn.f32_fwd_plan(B, H, Lq, Lk, D, ks)


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_plan_fits_a_cta(B, layout, H, Lq, ks, D):
    """Shared memory as the source lays it out, within one CTA's 227 KB;
    16 rows per warp; 32-key tiles exactly where 64 do not fit, or where
    they let two CTAs share an SM that 64-key tiles would leave to one and
    the grid holds more CTAs than SMs (MViT's 8-head blocks)."""
    *_, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    K = sum(ks)
    assert plan.smem == t_attn.f32_fwd_smem(D, plan.rows, plan.block_n, Lk, K)
    assert plan.smem <= 232_448
    assert plan.rows in (64, 128) and plan.threads == 2 * plan.rows
    s64, s32 = (t_attn.f32_fwd_smem(D, plan.rows, bn, Lk, K) for bn in (64, 32))
    if plan.splits > 1:  # a split takes 32-key tiles where two CTAs then share an SM
        assert plan.block_n == (32 if 2 * (s32 + 1024) <= 233_472 else 64)
    else:
        two = plan.ctas > 132 and 2 * (s32 + 1024) <= 233_472 < 2 * (s64 + 1024)
        assert plan.block_n == (32 if s64 > 232_448 or two else 64)
    if B == 2 and H == 8 and Lq in (672, 673) and D == 96:
        assert plan.block_n == 32 and 2 * (plan.smem + 1024) <= 233_472


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_grid_covers_every_row_and_key(B, layout, H, Lq, ks, D):
    """The kernel's decomposition of blockIdx.x covers every query row of
    every (batch, head) once, no CTA is empty, and the key tiles cover every
    key with the last one starting inside the keys."""
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    S = plan.splits
    assert plan.ctas == B * H * plan.q_tiles * S
    seen = np.zeros((B * H, Lq, plan.ntiles), np.int32)
    per = -(-plan.ntiles // S)
    for cta in range(plan.ctas):
        tile, rank = divmod(cta, S)
        bh, qt = divmod(tile, plan.q_tiles)
        t0, t1 = rank * per, min(plan.ntiles, (rank + 1) * per)
        assert t1 > t0  # no CTA of a cluster without keys
        seen[bh, qt * plan.rows:(qt + 1) * plan.rows, t0:t1] += 1
    assert (seen == 1).all()
    assert (plan.q_tiles - 1) * plan.rows < Lq <= plan.q_tiles * plan.rows
    assert (plan.ntiles - 1) * plan.block_n < Lk <= plan.ntiles * plan.block_n


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_plan_takes_128_rows_only_where_the_card_stays_full(B, layout, H, Lq, ks, D):
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    if plan.rows == 128:
        assert plan.ctas >= 132
    else:
        assert B * H * -(-Lq // 128) < 132 or t_attn.f32_fwd_smem(D, 128, 32, Lk, sum(ks)) > 232_448


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_plan_splits_the_keys_only_where_row_tiles_are_few(B, layout, H, Lq, ks, D):
    """A cluster of 2-8 CTAs shares a row tile's keys exactly where the row
    tiles are fewer than the SMs, and then the grid stays within two CTAs
    per SM and each CTA fits beside another where its key tiles are 32."""
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    tiles = B * H * plan.q_tiles
    if tiles >= 132 or Lk <= 32:
        assert plan.splits == 1
        return
    assert 2 <= plan.splits <= t_attn.F32_MAX_SPLITS and plan.ctas <= 2 * 132
    if plan.block_n == 32:
        assert 2 * (plan.smem + 1024) <= 233_472


def test_f32_plan_splits_phase_10s_small_grids():
    """The small models' 8-head blocks: 32 row-tile CTAs, the 385 keys over
    seven CTAs of a cluster (13 tiles of 32 keys, two each)."""
    plan = t_attn.f32_fwd_plan(2, 8, 96, 385, 96, (8, 8, 6))
    assert (plan.q_tiles * 16, plan.splits, plan.block_n, plan.ntiles) == (32, 7, 32, 13)


@pytest.mark.parametrize("D", [32, 48, 80, 160])
def test_f32_plan_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head_dim"):
        t_attn.f32_fwd_plan(2, 1, 100, 673, D, (8, 7, 12))


@pytest.mark.parametrize("ks", [(100, 20, 9), (1, 1, t_attn.MAX_REL_BWD - 1), (0, 0, 0)])
def test_f32_plan_refuses_bias_bins_outside_1_to_128(ks):
    with pytest.raises(ValueError, match="kt\\+kh\\+kw"):
        t_attn.f32_fwd_plan(2, 1, 100, 1 + ks[0] * ks[1] * ks[2], 96, ks)


def test_f32_plan_falls_back_to_32_key_tiles_then_refuses():
    """The key table grows with Lk: past what 64-key tiles leave room for,
    32-key tiles; past what those leave, a refusal."""
    ks = (8, 7, 12)
    sizes = {bn: max(Lk for Lk in range(1, 60_000, 64)
                     if t_attn.f32_fwd_smem(128, 64, bn, Lk, 27) <= 232_448) for bn in (64, 32)}
    assert sizes[32] > sizes[64]
    assert t_attn.f32_fwd_plan(2, 1, 100, sizes[64] + 64, 128, ks).block_n == 32
    with pytest.raises(ValueError, match="shared memory"):
        t_attn.f32_fwd_plan(2, 1, 100, sizes[32] + 64, 128, ks)


def test_f32_plan_mirrors_the_kernel_source():
    """What the plan shares with csrc/attention_f32_fwd.cu: the limits, the
    shared-memory layout's row strides, the order in which rows per CTA and
    keys per tile are tried, and the entry points' signatures (the plan is
    chosen inside the entry, from the shapes alone)."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert consts["SMEM_MAX"] == str(t_attn.SMEM_MAX)
    assert consts["NUM_SMS"] == str(t_attn.NUM_SMS)
    assert consts["MAX_K"] == str(t_attn.MAX_REL_BWD)
    for part in ("rows * (D + 8) * 4", "2 * bn * (D + 8) * 4", "2 * bn * (D + 4) * 4",
                 "ntiles * bn * 4", "rows * (K + 2) * 4"):
        assert part in src, part
    assert "p.B * p.H * ((p.Lq + 127) / 128) >= NUM_SMS ? 128 : 64" in src
    assert "for (int rows = first; rows >= 64; rows /= 2)" in src
    assert consts["SM_SMEM"] == str(t_attn.SM_SMEM)
    assert consts["MAX_SPLITS"] == str(t_attn.F32_MAX_SPLITS)
    assert "if (ctas < NUM_SMS && p.Lk > 32 && L32.total <= SMEM_MAX) {" in src
    assert "const int nt = (p.Lk + bn - 1) / bn, want = 2 * NUM_SMS / ctas;" in src
    assert "p.splits = (nt + per - 1) / per;" in src
    assert "const int per = (p.ntiles + S - 1) / S, t_begin = rank * per;" in src
    assert "int bn = L64.total <= SMEM_MAX ? 64 : 0;" in src
    assert ("(bn == 0 || (ctas > NUM_SMS && 2 * (L32.total + 1024) <= SM_SMEM &&\n"
            "                     2 * (L64.total + 1024) > SM_SMEM)))") in src
    for entry in ("dsal_bias_attention_f32", "dsal_cls_attention_f32"):
        sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
        assert [a.split()[-1] for a in sig.split(",")][-3:] == ["scale", "residual", "stream"]
