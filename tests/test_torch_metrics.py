"""The port's saliency metrics (`diff_sal_tpu_torch/metrics/`) against the
JAX package's, on the CPU.

- The numpy metrics (`saliency.py`): bit for bit, the jittered and the
  shuffled ones with the same `RandomState` on each side, maps of unequal
  size through the cv2 resize.
- The batched torch metrics (`device.py`) against JAX's jnp ones on the
  same maps: AUC-Judd within 1e-6, NSS, CC and SIM within 1e-5 relative,
  NaN on the same rows (a sample without fixations).
- The offline evaluator (`offline.py`) on one DHF1k-style and one AV-style
  tree of written images, numpy's global RNG seeded the same before each
  side (AUC-Judd's jitter draws from it in the pool's worker) and one
  process: the same CSV; `aggregate_results`: the same CSV.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diff_sal_tpu.metrics import device as jdev
from diff_sal_tpu.metrics import offline as joff
from diff_sal_tpu.metrics import saliency as jsal
from diff_sal_tpu_torch.metrics import device as tdev
from diff_sal_tpu_torch.metrics import offline as toff
from diff_sal_tpu_torch.metrics import saliency as tsal


def _maps(seed, shape=(24, 40), fix_shape=None):
    """A saliency map with ties (values on a coarse grid), a GT map and a
    sparse fixation map (at the GT's shape, which may differ)."""
    rng = np.random.RandomState(seed)
    fs = fix_shape or shape
    sal = np.round(rng.rand(*shape) * 50) / 50.0
    gt = rng.rand(*fs)
    fix = (rng.rand(*fs) > 0.9).astype(np.float64)
    return sal, gt, fix


@pytest.mark.parametrize("fix_shape", [None, (30, 36)], ids=["same", "resized"])
@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_metrics_are_the_jax_packages_bit_for_bit(seed, fix_shape):
    sal, gt, fix = _maps(seed, fix_shape=fix_shape)
    other = (np.random.RandomState(seed + 10).rand(*fix.shape) > 0.8).astype(np.float64)
    for method in ("range", "standard", "sum"):
        assert np.array_equal(tsal.normalize_map(sal, method), jsal.normalize_map(sal, method))
    assert tsal.AUC_Judd(sal, fix, rng=np.random.RandomState(3)) == jsal.AUC_Judd(
        sal, fix, rng=np.random.RandomState(3))
    assert tsal.AUC_Judd(sal, fix, jitter=False) == jsal.AUC_Judd(sal, fix, jitter=False)
    assert tsal.AUC_Borji(sal, fix, n_rep=8, rng=np.random.RandomState(4)) == jsal.AUC_Borji(
        sal, fix, n_rep=8, rng=np.random.RandomState(4))
    assert tsal.AUC_shuffled(sal, fix, other, n_rep=8,
                             rng=np.random.RandomState(5)) == jsal.AUC_shuffled(
        sal, fix, other, n_rep=8, rng=np.random.RandomState(5))
    assert tsal.NSS(sal, fix) == jsal.NSS(sal, fix)
    assert tsal.CC(sal, gt) == jsal.CC(sal, gt)
    assert tsal.SIM(sal, gt) == jsal.SIM(sal, gt)
    s_fix, s_rand = np.random.RandomState(6).rand(20), np.random.RandomState(7).rand(20, 4)
    assert np.array_equal(tsal._auc_sweep(s_fix, s_rand, 0.1), jsal._auc_sweep(s_fix, s_rand, 0.1))
    # no fixation: NaN on both sides
    assert np.isnan(tsal.AUC_Judd(sal, np.zeros(fix.shape))) and np.isnan(
        tsal.AUC_Borji(sal, np.zeros(fix.shape)))


def test_device_metrics_match_jax():
    rng = np.random.RandomState(0)
    B, H, W = 4, 20, 28
    # ties: values on a coarse grid
    sal = (np.round(rng.rand(B, H, W, 1) * 40) / 40.0).astype(np.float32)
    gt = rng.rand(B, H, W, 1).astype(np.float32)
    fix = (rng.rand(B, H, W, 1) > 0.93).astype(np.float32)
    fix[2] = 0.0  # a sample without fixations: NaN
    pairs = [(tdev.auc_judd, jdev.auc_judd, (sal, fix)), (tdev.nss_fix, jdev.nss_fix, (sal, fix)),
             (tdev.cc_maps, jdev.cc_maps, (sal, gt)), (tdev.sim_maps, jdev.sim_maps, (sal, gt))]
    for t_fn, j_fn, args in pairs:
        got = t_fn(*(torch.from_numpy(a) for a in args)).numpy()
        ref = np.asarray(j_fn(*(jnp.asarray(a) for a in args)))
        assert got.shape == ref.shape == (B,) and got.dtype == np.float32, t_fn.__name__
        assert np.array_equal(np.isnan(got), np.isnan(ref)), (t_fn.__name__, got, ref)
        ok = ~np.isnan(ref)
        if t_fn is tdev.auc_judd:
            np.testing.assert_allclose(got[ok], ref[ok], atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-5, atol=0)
    assert np.isnan(tdev.auc_judd(torch.from_numpy(sal), torch.from_numpy(fix)).numpy()[2])


def test_device_auc_judd_tracks_the_numpy_metric():
    """Ties broken by jitter in the numpy metric, averaged in the batched
    one: on maps without ties the two agree."""
    rng = np.random.RandomState(1)
    sal = rng.rand(2, 16, 24).astype(np.float32)
    fix = (rng.rand(2, 16, 24) > 0.9).astype(np.float32)
    got = tdev.auc_judd(torch.from_numpy(sal), torch.from_numpy(fix)).numpy()
    ref = [tsal.AUC_Judd(sal[i], fix[i], jitter=False) for i in range(2)]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _write_trees(root):
    """A DHF1k-style prediction tree (<task>/<vid>/%04d.png against
    <gt>/%04d/{maps,fixation}/%04d.png) and an AV-style one, as `test-av`
    dumps it (<ds>/<vid>/pred_sal_%06d.jpg against <gt>/<vid>/{maps,
    fixation}/*.jpg, paired by sorted order; one video without fixation
    maps)."""
    rng = np.random.RandomState(2)
    u8 = lambda *s: rng.randint(0, 256, s, dtype=np.uint8)  # noqa: E731
    fixmap = lambda *s: ((rng.rand(*s) > 0.95) * 255).astype(np.uint8)  # noqa: E731
    for task in ("task0", "task1"):
        for vid in (601, 602):
            for i in (1, 2):
                _png(f"{root}/dhf_pred/{task}/{vid}/{i:04d}.png", u8(18, 30))
    for vid in (601, 602):
        for i in (1, 2):
            _png(f"{root}/dhf_gt/{vid:04d}/maps/{i:04d}.png", u8(24, 40))
            _png(f"{root}/dhf_gt/{vid:04d}/fixation/{i:04d}.png", fixmap(24, 40))
    for ds, vid in (("avad", "v1"), ("avad", "v2"), ("diem", "v3")):
        for i in (3, 4):
            _png(f"{root}/av_pred/{ds}/{vid}/pred_sal_{i:06d}.jpg", u8(18, 30))
            _png(f"{root}/av_gt/{vid}/maps/eyeMap_{i:05d}.jpg", u8(24, 40))
            if vid != "v2":
                _png(f"{root}/av_gt/{vid}/fixation/eyeMap_{i:05d}.jpg", fixmap(24, 40))


def _evaluate(module, pred, gt, data_type):
    np.random.seed(11)
    res = module.evaluate_predictions(pred, gt, data_type, processes=1)
    csv = pred + "_metrics.csv"
    with open(csv) as f:
        text = f.read()
    os.remove(csv)
    return res, text


@pytest.mark.parametrize("tree", ["dhf1k", "av"])
def test_offline_evaluation_writes_the_jax_packages_csv(tmp_path, tree):
    root = str(tmp_path)
    _write_trees(root)
    pred, gt = (f"{root}/dhf_pred", f"{root}/dhf_gt") if tree == "dhf1k" else (
        f"{root}/av_pred", f"{root}/av_gt")
    j_res, j_csv = _evaluate(joff, pred, gt, tree)
    t_res, t_csv = _evaluate(toff, pred, gt, tree)
    assert t_csv == j_csv and len(t_csv.splitlines()) == 3, (t_csv, j_csv)
    assert list(t_res) == list(j_res)
    for k in j_res:
        assert np.array_equal(t_res[k], j_res[k], equal_nan=True)
    pair = (f"{root}/dhf_pred/task0/601/0001.png", f"{root}/dhf_gt/0601/maps/0001.png",
            f"{root}/dhf_gt/0601/fixation/0001.png")
    np.random.seed(12)
    j_pair = joff.score_pair(pair)
    np.random.seed(12)
    assert toff.score_pair(pair) == j_pair


def test_aggregate_results_writes_the_jax_packages_csv(tmp_path):
    src = tmp_path / "results"
    src.mkdir()
    (src / "a_metrics.csv").write_text("Task,AUC_J ,CC \ntask0,0.9,0.5\n")
    (src / "b.txt").write_text("Task,AUC_J ,CC \ntask1,0.8,0.4\ntask2,0.7,0.3\n")
    (src / "ignored.json").write_text("{}")
    (src / "empty.csv").write_text("")
    j_out = joff.aggregate_results(str(src), str(tmp_path / "j.csv"))
    t_out = toff.aggregate_results(str(src), str(tmp_path / "t.csv"))
    assert open(t_out).read() == open(j_out).read()
    assert "source" in open(t_out).read()
