"""The host-side plan of the f32 attention backward (`f32_bwd_plan` in
`diff_sal_tpu_torch/ops/attention.py`): the geometry
`csrc/attention_f32.cu` chooses for K5 and K12's backward in f32, checked
on the CPU at the shapes the paths send: MViTv2-small's seven block shapes
(224x384x16) in both layouts at B = 2 and 4, and the small models of
`chip_smoke.py`'s f32 phase (MViT tiny at 128x96), at every head_dim the
kernels take."""

import re
from pathlib import Path

import numpy as np
import pytest

from diff_sal_tpu_torch.ops import attention as t_attn
from test_torch_attention_plan import MVIT_BLOCKS
from test_torch_f32_attention_plan import TINY_BLOCKS

CSRC = Path(t_attn.__file__).resolve().parent.parent / "csrc" / "attention_f32.cu"

CASES = [(B, layout, H, Lq, ks, D) for B in (2, 4) for layout in ("k1", "k12")
         for H, Lq, ks in MVIT_BLOCKS + TINY_BLOCKS for D in t_attn.HEAD_DIMS]
IDS = [f"B{B}-{layout}-H{H}-Lq{Lq}-kh{ks[1]}-D{D}" for B, layout, H, Lq, ks, D in CASES]


def _launch(B, layout, H, Lq, ks, D):
    """(batches, heads, Lq, Lk, plan) as the wrapper of that layout calls it."""
    Lk = 1 + ks[0] * ks[1] * ks[2]
    if layout == "k12":
        B, H, Lq = B * H, 1, Lq + 1
    return B, H, Lq, Lk, t_attn.f32_bwd_plan(B, H, Lq, Lk, D, ks)


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_bwd_plan_fits_a_cta(B, layout, H, Lq, ks, D):
    """Shared memory as the source lays it out, within one CTA's 227 KB (two
    CTAs per SM at head_dim 96 with up to 48 bins, MViT's widths); 16 query
    rows per q-major warp; the drel product's N the bins padded to 32, 48
    or 128."""
    *_, plan = _launch(B, layout, H, Lq, ks, D)
    K = sum(ks)
    assert (plan.smem_q, plan.smem_k) == t_attn.f32_bwd_smem(D, plan.q_rows, K)
    assert max(plan.smem_q, plan.smem_k) <= t_attn.SMEM_MAX
    assert plan.q_rows in (16, 32, 64)
    assert plan.bins == (32 if K <= 32 else (48 if K <= 48 else 128)) >= K
    if D == 96 and K <= 48:
        assert 2 * (max(plan.smem_q, plan.smem_k) + 1024) <= t_attn.SM_SMEM


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_bwd_q_grid_covers_every_row_and_key(B, layout, H, Lq, ks, D):
    """The q-major kernel's decomposition of blockIdx.x covers every query
    row of every (batch, head) once, and its key tiles cover every key, the
    last one starting inside the keys."""
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    q_tiles = -(-Lq // plan.q_rows)
    assert plan.q_ctas == B * H * q_tiles
    seen = np.zeros((B * H, q_tiles * plan.q_rows), np.int32)
    for cta in range(plan.q_ctas):
        bh, qt = divmod(cta, q_tiles)
        seen[bh, qt * plan.q_rows:(qt + 1) * plan.q_rows] += 1
    assert (seen == 1).all() and (q_tiles - 1) * plan.q_rows < Lq
    assert (plan.key_tiles - 1) * plan.block_n < Lk <= plan.key_tiles * plan.block_n


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_bwd_k_grid_covers_every_key_once_per_split(B, layout, H, Lq, ks, D):
    """The k-major kernel's decomposition of blockIdx.x (batch-head, query
    split, key tile) covers every key of every (batch, head) once per split,
    and the splits cover every query tile once, none empty."""
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    ktiles = -(-Lk // plan.k_rows)
    assert plan.k_ctas == B * H * plan.splits * ktiles
    assert plan.q_tiles == -(-Lq // plan.block_m)
    keys = np.zeros((B * H, plan.splits, ktiles * plan.k_rows), np.int32)
    rows = np.zeros((B * H, plan.q_tiles), np.int32)
    for cta in range(plan.k_ctas):
        bh, rem = divmod(cta, plan.splits * ktiles)
        split, kt = divmod(rem, ktiles)
        keys[bh, split, kt * plan.k_rows:(kt + 1) * plan.k_rows] += 1
        q0, q1 = split * plan.per_split, min(plan.q_tiles, (split + 1) * plan.per_split)
        assert q1 > q0  # no empty split
        if kt == 0:
            rows[bh, q0:q1] += 1
    assert (keys == 1).all() and (rows == 1).all()


@pytest.mark.parametrize("B,layout,H,Lq,ks,D", CASES, ids=IDS)
def test_f32_bwd_plan_fills_the_card_where_grids_are_small(B, layout, H, Lq, ks, D):
    """The q-major CTAs shrink to 32 or 16 rows only where 64 would leave
    SMs idle; the k-major kernel's query splits give the fewest query tiles
    per CTA times waves of CTAs (two per SM where two fit) of every count
    that leaves no split empty within eight waves, and no more splits than
    that takes."""
    B, H, Lq, Lk, plan = _launch(B, layout, H, Lq, ks, D)
    if plan.q_rows < 64:
        assert B * H * -(-Lq // (2 * plan.q_rows)) < 132
    if plan.q_rows > 16:
        assert plan.q_ctas >= 132
    slots = 132 * (2 if 2 * (plan.smem_k + 1024) <= t_attn.SM_SMEM else 1)
    ctas = plan.k_ctas // plan.splits
    cost = {s: -(-ctas * s // slots) * -(-plan.q_tiles // s) for s in range(1, plan.q_tiles + 1)
            if -(-plan.q_tiles // -(-plan.q_tiles // s)) == s
            and (s == 1 or ctas * s <= 8 * slots)}
    assert plan.splits == min(cost, key=lambda s: (cost[s], s))
    assert plan.per_split == -(-plan.q_tiles // plan.splits)


def test_f32_bwd_plan_splits_phase_10s_small_grids():
    """The small models' 8-head blocks (B=2, 96 query rows, 385 keys): 16-row
    q-major CTAs (96 of them, not 32), and two query splits of the three
    32-row tiles, which keep the 224 k-major CTAs in one wave (three splits
    would take two waves for one tile each)."""
    plan = t_attn.f32_bwd_plan(2, 8, 96, 385, 96, (8, 8, 6))
    assert (plan.q_rows, plan.q_ctas, plan.splits, plan.k_ctas) == (16, 96, 2, 224)


def test_f32_bwd_plan_fills_whole_waves_at_full_width():
    """MViT's ten 4-head blocks at B=4 (2688 query rows, 673 keys): 176
    k-major CTAs are 0.67 of a wave of 264; two splits would make 1.33
    waves (two wave-times for 42 tiles each), three make two full waves of
    28 tiles each."""
    plan = t_attn.f32_bwd_plan(4, 4, 2688, 673, 96, (8, 7, 12))
    assert (plan.splits, plan.k_ctas, plan.per_split) == (3, 528, 28)


@pytest.mark.parametrize("D", [32, 48, 80, 160])
def test_f32_bwd_plan_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head_dim"):
        t_attn.f32_bwd_plan(2, 1, 100, 673, D, (8, 7, 12))


@pytest.mark.parametrize("ks", [(100, 20, 9), (1, 1, t_attn.MAX_REL_BWD), (0, 0, 0)])
def test_f32_bwd_plan_refuses_bias_bins_outside_1_to_128(ks):
    with pytest.raises(ValueError, match="kt\\+kh\\+kw"):
        t_attn.f32_bwd_plan(2, 1, 100, 1 + ks[0] * ks[1] * ks[2], 96, ks)


@pytest.mark.parametrize("Lk", [1, 2, 33, 20_001, 100_001])
def test_f32_bwd_plan_takes_any_key_count(Lk):
    """Shared memory does not grow with Lk (the key tables are per tile):
    every key count is taken."""
    plan = t_attn.f32_bwd_plan(2, 1, 100, Lk, 128, (8, 7, 12))
    assert plan.smem_q == t_attn.f32_bwd_smem(128, plan.q_rows, 27)[0]


def test_f32_bwd_plan_mirrors_the_kernel_source():
    """What the plan shares with csrc/attention_f32.cu: the limits, the tile
    sizes, the shared-memory layouts, the choice of rows per q-major CTA,
    of the drel width and of the splits (which the entry checks against
    its argument), and the entry points' signatures."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert consts["SMEM_MAX"] == str(t_attn.SMEM_MAX)
    assert consts["NUM_SMS"] == str(t_attn.NUM_SMS)
    assert consts["SM_SMEM"] == str(t_attn.SM_SMEM)
    assert consts["MAX_WAVES"] == str(t_attn.F32_BWD_MAX_WAVES)
    assert consts["MAX_K"] == str(t_attn.MAX_REL_BWD)
    assert consts["BN"] == str(t_attn.F32_BWD_BN)
    assert consts["BM"] == str(t_attn.F32_BWD_BM)
    assert int(consts["KW"]) * 16 == t_attn.F32_BWD_KROWS
    assert "constexpr int KROWS = 16 * KW;" in src
    assert ("return 4 * (2 * rows * (D + 4) + 4 * BN * (D + 4) + 2 * BN + rows * (K + 2));"
            in src)
    assert ("return 4 * (2 * KROWS * (D + 4) + 4 * BM * (D + 4) + 2 * BM * (K + 2) + 4 * BM);"
            in src)
    assert "if (BH * ((Lq + 63) / 64) >= NUM_SMS) return 64;" in src
    assert "return BH * ((Lq + 31) / 32) >= NUM_SMS ? 32 : 16;" in src
    assert "int pad_bins(int K) { return K <= 32 ? 32 : (K <= 48 ? 48 : 128); }" in src
    assert ("const long long slots = (2 * (k_smem(D, K) + 1024) <= SM_SMEM ? 2 : 1) * NUM_SMS;"
            in src)
    assert "const long long cap = MAX_WAVES * slots / ctas;" in src
    assert "for (int s = 1; s <= n_qt && (s == 1 || s <= cap); ++s) {" in src
    assert "if ((n_qt + per - 1) / per != s) continue;" in src
    assert "const long long cost = ((long long)ctas * s + slots - 1) / slots * per;" in src
    assert "if (best < 0 || cost < best) {" in src
    assert "p.splits != plan_splits(p.B * p.H, p.Lq, p.Lk, D, K)" in src
    assert "const int qt0 = si * per, qt1 = min(n_qt, qt0 + per);" in src
    for entry, n in (("dsal_bias_attention_bwd_f32", len(t_attn.F32_BWD_KERNEL.argtypes)),
                     ("dsal_cls_attention_bwd_f32", len(t_attn.CLS_F32_BWD_KERNEL.argtypes))):
        sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src).group(1)
        names = [a.split()[-1] for a in sig.split(",")]
        assert len(names) == n and names[-4:] == ["splits", "scale", "residual", "stream"]
