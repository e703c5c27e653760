"""K11's host-side plan (`pool_plan` in `diff_sal_tpu_torch/ops/pool.py`):
the launch geometry `dsal_depthwise_pool3d` in `csrc/pool.cu` uses, checked
on the CPU at every pool call of the full-width AV model (MViT-small at
224x384x16, B=2: each block's q and kv pools, or one qkv pool where the
strides agree, 30 calls of 11 shapes) and at ragged shapes: that the
threads' strips, plane blocks, rows and channel pairs cover every output
once, that the grid gives every SM a CTA where the shape allows and splits
the walk over T no further than that needs, that the plan agrees with the
constants and checks of the CUDA source (it uses no shared memory); and
the eval-time cache of MViT's tiled pool weight
(`MultiScaleAttention._pool_weight`)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diff_sal_tpu_torch.config import ModelConfig, MViTConfig
from diff_sal_tpu_torch.models.mvit import MultiScaleAttention, block_plan
from diff_sal_tpu_torch.ops import pool as t_pool

CSRC = Path(t_pool.__file__).resolve().parent.parent / "csrc" / "pool.cu"


def _mvit_calls(B=2):
    """(B, T, H, W, C, sh, sw) of every K11 call of one AV run, in order."""
    calls = []
    for p in block_plan(ModelConfig.audio_visual().visual):
        C, (T, H, W) = p["out_dims"], p["in_size"]
        parts = ([(3 * C, p["stride_q"])] if p["stride_q"] == p["stride_kv"]
                 else [(C, p["stride_q"]), (2 * C, p["stride_kv"])])
        calls += [(B, T, H, W, c, s[1], s[2]) for c, s in parts]
    return calls


MVIT = _mvit_calls()
RAGGED = [(1, 1, 1, 1, 8, 1, 1), (1, 3, 5, 9, 24, 2, 2), (3, 2, 13, 7, 24, 3, 5),
          (1, 7, 4, 30, 8, 1, 2), (2, 5, 17, 3, 96, 8, 8), (1, 9, 2, 2, 2304, 1, 1),
          (4, 16, 56, 96, 96, 1, 1), (1, 1, 3, 3, 16, 4, 4)]
CASES = sorted(set(MVIT)) + RAGGED
IDS = ["x{}x{}x{}x{}x{}-s{}{}".format(*c) for c in CASES]


def test_the_model_makes_thirty_pool_calls():
    assert len(MVIT) == 30 and len(set(MVIT)) == 11


def _axis_cover(n, block, blocks):
    """How often each of n positions is covered by `blocks` blocks of
    `block` consecutive positions (the last one clipped)."""
    seen = np.zeros(blocks * block, np.int32)
    for i in range(blocks):
        seen[i * block:(i + 1) * block] += 1
    return seen[:n], seen[n:]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("B,T,H,W,C,sh,sw", CASES, ids=IDS)
def test_every_output_is_covered_once(B, T, H, W, C, sh, sw):
    """The kernel's thread index runs over (b, plane block, ho, strip,
    channel pair): every output (b, t, ho, wo, c) falls to one thread, and
    no thread owns only outputs past the edge."""
    plan = t_pool.pool_plan(B, T, H, W, C, sh, sw)
    Ho, Wo = (H - 1) // sh + 1, (W - 1) // sw + 1
    t_in, _ = _axis_cover(T, plan.t_block, plan.t_blocks)
    w_in, _ = _axis_cover(Wo, plan.strip, plan.strips)
    assert (t_in == 1).all() and (w_in == 1).all()
    assert (plan.t_blocks - 1) * plan.t_block < T and (plan.strips - 1) * plan.strip < Wo
    assert plan.threads == B * plan.t_blocks * Ho * plan.strips * (C // t_pool.POOL_V)
    assert plan.ctas == _cdiv(plan.threads, t_pool.POOL_THREADS)
    assert 1 <= plan.t_block <= T and plan.strip == (4 if sw <= 2 else 1)


@pytest.mark.parametrize("B,T,H,W,C,sh,sw", CASES, ids=IDS)
def test_the_walk_is_split_only_where_an_sm_would_idle(B, T, H, W, C, sh, sw):
    """All T walked by each thread wherever the grid gives every SM a CTA;
    else the walk halved, no further than that needs. (One CTA per SM, not
    two: halving until two CTAs sit on every SM was slower per DPM++ run on
    the card, PERF.md §6, PR 11.)"""
    plan = t_pool.pool_plan(B, T, H, W, C, sh, sw)
    per_block = plan.threads // plan.t_blocks
    walks = [T]
    while walks[-1] > 1:
        walks.append(_cdiv(walks[-1], 2))
    for tb in walks[:walks.index(plan.t_block)]:
        assert _cdiv(per_block * _cdiv(T, tb), t_pool.POOL_THREADS) < t_pool.NUM_SMS
    assert plan.ctas >= t_pool.NUM_SMS or plan.t_block == 1


def test_the_full_width_calls_reach_every_sm():
    """Every pool of the full-width AV run gives every SM a CTA; block 0's
    stride-1 q pool walks all eight planes in strips of four, its stride-8
    kv pool shares no column taps (strip 1) and splits its planes."""
    plans = {c: t_pool.pool_plan(*c) for c in MVIT}
    q0, kv0 = plans[(2, 8, 56, 96, 96, 1, 1)], plans[(2, 8, 56, 96, 192, 8, 8)]
    assert (q0.strip, q0.t_block) == (4, 8)
    assert kv0.strip == 1 and kv0.t_block < 8
    assert all(p.ctas >= t_pool.NUM_SMS for p in plans.values())


@pytest.mark.parametrize("args", [(1, 1, 1, 1, 5, 1, 1), (1, 1, 1, 1, 0, 1, 1),
                                  (0, 1, 1, 1, 8, 1, 1), (1, 1, 1, 1, 8, 0, 1)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        t_pool.pool_plan(*args)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _entry_accepts(B, T, H, W, C, ps, Ho, Wo, sh, sw, strip, tb):
    """The checks of the C entry `dsal_depthwise_pool3d`, transcribed."""
    V = t_pool.POOL_V
    return not (B < 1 or T < 1 or H < 1 or W < 1 or C < V or C % V != 0 or ps < C or ps % V != 0
                or sh < 1 or sw < 1 or Ho != (H - 1) // sh + 1 or Wo != (W - 1) // sw + 1
                or strip not in (1, 4) or tb < 1 or tb > T
                or B * -(-T // tb) * Ho * -(-Wo // strip) * (C // V) >= 2 ** 31
                or H * W * ps >= 2 ** 31)


def test_plan_mirrors_the_kernel_source():
    """The constants the plan shares with csrc/pool.cu, the strips its
    dispatch instantiates, the launch without dynamic shared memory, the
    entry's trailing plan arguments and its checks, transcribed."""
    src = CSRC.read_text()
    assert _constant(src, "THREADS") == t_pool.POOL_THREADS
    assert _constant(src, "V") == t_pool.POOL_V
    assert "if (strip == 4) return launch_sc<T, 4>" in src and "return launch_sc<T, 1>" in src
    assert "<<<blocks, THREADS, 0, stream>>>" in src  # no shared memory to run out of
    sig = re.search(r'extern "C" int dsal_depthwise_pool3d\(([^)]*)\)', src).group(1)
    names = [a.split()[-1] for a in sig.split(",")]
    assert names[-4:] == ["strip", "tb", "is_bf16", "stream"]
    assert len(names) == len(t_pool.KERNEL.argtypes)
    for B, T, H, W, C, sh, sw in CASES:
        p = t_pool.pool_plan(B, T, H, W, C, sh, sw)
        assert _entry_accepts(B, T, H, W, C, 3 * C, (H - 1) // sh + 1, (W - 1) // sw + 1, sh,
                              sw, p.strip, p.t_block)
    assert not _entry_accepts(1, 4, 5, 5, 16, 16, 5, 5, 1, 1, 2, 1)  # no such strip
    assert not _entry_accepts(1, 4, 5, 5, 16, 16, 5, 5, 1, 1, 4, 5)  # walk past T
    assert not _entry_accepts(1, 4, 5, 5, 15, 16, 5, 5, 1, 1, 4, 1)  # C not in pairs


# ------------------------------------------------- the tiled pool weight ---


def _attention():
    cfg = MViTConfig.tiny(spatial_size=(32, 48), pool_mode="pallas")
    p = block_plan(cfg)[1]
    torch.manual_seed(0)
    return MultiScaleAttention(p["in_dims"], p["out_dims"], p["num_heads"], p["stride_q"],
                               p["stride_kv"], p["rel_pos_dims"], pool_mode="pallas")


def _tiled(m, parts):
    return torch.cat([getattr(m, f"pool_{p}").weight[:, 0].permute(1, 2, 3, 0)
                      .repeat(1, 1, 1, m.num_heads) for p in parts], -1).float()


def test_the_eval_weight_is_kept_and_follows_an_in_place_update():
    m = _attention()
    with torch.no_grad():
        w1 = m._pool_weight("kv")
        assert m._pool_weight("kv") is w1  # kept, not rebuilt
        torch.testing.assert_close(w1, _tiled(m, "kv"), rtol=0, atol=0)
        m.pool_k.weight.mul_(2.0)  # an optimizer's in-place update
        w2 = m._pool_weight("kv")
        assert w2 is not w1
        torch.testing.assert_close(w2, _tiled(m, "kv"), rtol=0, atol=0)
        m.load_state_dict({k: v * 0.5 for k, v in m.state_dict().items()})
        torch.testing.assert_close(m._pool_weight("kv"), _tiled(m, "kv"), rtol=0, atol=0)
    m.double()  # a new dtype rebuilds it
    with torch.no_grad():
        torch.testing.assert_close(m._pool_weight("q"), _tiled(m, "q"), rtol=0, atol=0)


def test_gradients_reach_the_pool_weights_in_train_mode():
    m = _attention()
    with torch.no_grad():
        m._pool_weight("kv")  # an eval copy exists; training must not use it
    w = m._pool_weight("kv")
    assert w.requires_grad and w.grad_fn is not None
    x = torch.randn(1, 2, 4, 6, w.shape[-1])
    t_pool.depthwise_pool3d(x, w, (1, 2, 2)).square().sum().backward()
    for p in ("k", "v"):
        g = getattr(m, f"pool_{p}").weight.grad
        assert g is not None and float(g.abs().max()) > 0, p
