"""The port's training pieces against the JAX package's, on the CPU in
f32: losses and eval scores, the optimizer against optax, EMA, BatchNorm
in train mode against flax, dropout and DropPath, the dequantization
transform, q_sample, configs, and the decoder's routing of the block tail
(kernel K3 at eval only).

Inputs are drawn with numpy from fixed seeds and fed to both sides.
Tolerances: elementwise math and per-sample reductions over a few
thousand f32 values agree to 1e-5 relative, 1e-6 absolute where a
correlation cancels to near 0; optimizer state and
parameters to 1e-6 (updates are of size lr = 1e-3 here).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.data.transforms import data_transform as j_data_transform
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
from diff_sal_tpu.diffusion.schedule import q_sample as j_q_sample
from diff_sal_tpu.models.layers import drop_path as j_drop_path
from diff_sal_tpu.train import ema as j_ema
from diff_sal_tpu.train import losses as jl
from diff_sal_tpu.train.optim import make_optimizer as j_make_optimizer
from diff_sal_tpu.train.optim import multistep_lr as j_multistep_lr
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.data.transforms import data_transform
from diff_sal_tpu_torch.diffusion.schedule import make_schedule, q_sample
from diff_sal_tpu_torch.models import layers
from diff_sal_tpu_torch.models.sal_unet import SalUNet
from diff_sal_tpu_torch.ops import mlp as mlp_ops
from diff_sal_tpu_torch.train import ema as t_ema
from diff_sal_tpu_torch.train import losses as tl
from diff_sal_tpu_torch.train.optim import Optimizer, multistep_lr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU, and several processes of spinning
    OpenMP threads made the training steps here 20-70x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _maps(seed, B=3, hw=(12, 16)):
    rng = np.random.RandomState(seed)
    pred = (1 / (1 + np.exp(-rng.randn(B, *hw, 1)))).astype(np.float32)
    gt = rng.rand(B, *hw, 1).astype(np.float32)
    return pred, gt


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref), rtol=rtol, atol=atol)


# ------------------------------------------------------------- losses -----


@pytest.mark.parametrize("name", ["mse_loss", "nss", "cc", "kldiv", "similarity"])
def test_loss_functions_match_jax(name):
    pred, gt = _maps(41)
    ref = getattr(jl, name)(jnp.asarray(pred), jnp.asarray(gt))
    _close(getattr(tl, name)(torch.from_numpy(pred), torch.from_numpy(gt)), ref)
    if name != "mse_loss":  # per-sample values too
        ref = getattr(jl, name)(jnp.asarray(pred), jnp.asarray(gt), reduce=False)
        _close(getattr(tl, name)(torch.from_numpy(pred), torch.from_numpy(gt), reduce=False),
               ref)


def test_bce_loss_matches_jax():
    rng = np.random.RandomState(42)
    logits = rng.randn(2, 8, 8, 1).astype(np.float32) * 3
    label = (rng.rand(2, 8, 8, 1) * 255).astype(np.float32)
    _close(tl.bce_loss(torch.from_numpy(logits), torch.from_numpy(label), 0.7),
           jl.bce_loss(jnp.asarray(logits), jnp.asarray(label), 0.7))


@pytest.mark.parametrize("flags", [{}, {"loss_kl": True, "loss_cc": True},
                                   {"loss_cc": True, "loss_sim": True, "loss_nss": True}])
def test_training_loss_matches_jax(flags):
    pred, gt = _maps(43)
    ref = jl.training_loss(jc.LossConfig(**flags), jnp.asarray(pred), jnp.asarray(gt))
    out = tl.training_loss(pc.LossConfig(**flags), torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k], atol=1e-6)


@pytest.mark.parametrize("mask", [None, [1, 0, 1]])
def test_eval_scores_match_jax(mask):
    pred, gt = _maps(44)
    m = None if mask is None else np.asarray(mask, np.float32)
    ref = jl.eval_scores(jnp.asarray(pred), jnp.asarray(gt),
                         mask=None if m is None else jnp.asarray(m))
    out = tl.eval_scores(torch.from_numpy(pred), torch.from_numpy(gt),
                         mask=None if m is None else torch.from_numpy(m))
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k])


# ---------------------------------------------------------- optimizer -----


def test_multistep_lr_matches_optax_schedule():
    ours, ref = multistep_lr(1e-4, 100, 4), j_multistep_lr(1e-4, steps_per_epoch=100, n_epochs=4)
    for count in (0, 1, 199, 200, 201, 299, 300, 1000):
        assert ours(count) == float(ref(count)), count


def test_optimizer_matches_optax_across_a_milestone_and_the_clip():
    """Eight steps with the same gradients on both sides: norms above and
    below grad_clip = 1, milestones at steps 4 and 6 (2 steps per epoch, 4
    epochs), one leaf without a gradient at step 3 (zeros on the JAX side),
    and a frozen parameter that neither side moves."""
    rng = np.random.RandomState(45)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfg = jc.OptimConfig(lr=1e-3)
    tx = j_make_optimizer(cfg, steps_per_epoch=2, n_epochs=4)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)

    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = Optimizer(params + [frozen], pc.from_fields(cfg), multistep_lr(1e-3, 2, 4))
    norms = []
    for step in range(8):
        scale = 3.0 if step % 2 == 0 else 0.05
        grads = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
        if step == 3:
            grads["b"] = np.zeros(shapes["b"], np.float32)
        for p, k in zip(params, shapes):
            p.grad = None if (step == 3 and k == "b") else torch.from_numpy(grads[k])
        norm = opt.step()
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        norms.append(float(norm))
        adam = jstate[1][0]
        for i, k in enumerate(shapes):
            _close(params[i], jparams[k], rtol=0, atol=1e-6)
            _close(opt.mu[i], adam.mu[k], rtol=0, atol=1e-6)
            _close(opt.nu[i], adam.nu[k], rtol=0, atol=1e-6)
        assert int(adam.count) == opt.count == step + 1
    assert max(norms) > 1.0 > min(norms)  # the clip both triggered and not
    assert torch.equal(frozen, torch.ones(3)) and len(opt.params) == 3


def test_ema_update_matches_jax():
    rng = np.random.RandomState(46)
    ema = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    ref = j_ema.ema_update(ema, new, 0.99)
    out = t_ema.ema_update({k: torch.from_numpy(v.copy()) for k, v in ema.items()},
                           {k: torch.from_numpy(v) for k, v in new.items()}, 0.99)
    for k in ema:
        _close(out[k], ref[k], rtol=0, atol=1e-7)
    model = torch.nn.Linear(3, 2)
    shadow = t_ema.ema_init(model)
    assert set(shadow) == {"weight", "bias"} and torch.equal(shadow["weight"], model.weight)


# ------------------------------------------------- BatchNorm and masks -----


def test_batchnorm_train_mode_matches_flax():
    """Output and updated running statistics of flax nn.BatchNorm(
    use_running_average=False, momentum=0.9, epsilon=1e-5); torch's own
    running-variance update (unbiased) would differ by N/(N-1)."""
    rng = np.random.RandomState(47)
    x = (rng.randn(2, 5, 6, 8) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.rand(8).astype(np.float32) + 0.5, rng.randn(8).astype(np.float32)
    mean, var = rng.randn(8).astype(np.float32), rng.rand(8).astype(np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    ref, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    port = layers.BatchNorm(8)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(port, name).copy_(torch.from_numpy(v))
    out = port(torch.from_numpy(x), train=True)
    _close(out, ref, rtol=0, atol=1e-5)
    _close(port.running_mean, upd["batch_stats"]["mean"], rtol=0, atol=1e-6)
    _close(port.running_var, upd["batch_stats"]["var"], rtol=0, atol=1e-6)
    assert int(port.num_batches_tracked) == 0
    with torch.no_grad():  # eval mode reads the updated running statistics
        ev = port(torch.from_numpy(x))
    ref_ev = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    _close(ev, ref_ev, rtol=0, atol=1e-5)


def test_drop_path_with_given_mask_matches_jax():
    rng = np.random.RandomState(48)
    x = rng.randn(6, 4, 5).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = j_drop_path(jnp.asarray(x), 0.3, False, key)
    mask = np.floor(0.7 + np.asarray(jax.random.uniform(key, (6, 1, 1), jnp.float32)))
    out = layers.drop_path(torch.from_numpy(x), 0.3, True, mask=torch.from_numpy(mask))
    _close(out, ref, rtol=0, atol=1e-6)
    assert torch.equal(layers.drop_path(torch.from_numpy(x), 0.3, False), torch.from_numpy(x))


def test_dropout_with_given_mask_matches_flax():
    rng = np.random.RandomState(49)
    x = (rng.rand(8, 16).astype(np.float32) + 0.5)  # no zeros: the kept set is out != 0
    ref = fnn.Dropout(0.25).apply({}, jnp.asarray(x), deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(4)})
    keep = torch.from_numpy(np.asarray(ref) != 0)
    out = layers.dropout(torch.from_numpy(x), 0.25, True, keep=keep)
    _close(out, ref, rtol=0, atol=1e-6)


def test_mask_statistics_over_many_draws():
    g = torch.Generator().manual_seed(50)
    x = torch.ones(20000, 1, 3)
    dp = layers.drop_path(x, 0.15, True, g)
    kept = (dp[:, 0, 0] > 0).float()
    assert abs(float(kept.mean()) - 0.85) < 4 * (0.85 * 0.15 / 20000) ** 0.5
    assert torch.allclose(dp[kept.bool()], torch.full((), 1 / 0.85))
    assert bool((dp[:, 0] == dp[:, 0, :1]).all())  # one draw per sample
    do = layers.dropout(torch.ones(200, 100), 0.1, True, g)
    assert abs(float((do > 0).float().mean()) - 0.9) < 4 * (0.9 * 0.1 / 20000) ** 0.5
    assert torch.equal(layers.dropout(x, 0.1, False, g), x)


# ------------------------------------------- data transform, q_sample -----


@pytest.mark.parametrize("kind", ["gaussian", "uniform"])
def test_data_transform_matches_jax(kind):
    rng = np.random.RandomState(51)
    x = rng.rand(2, 8, 8, 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jcfg = jc.DataTransformConfig(gaussian_dequantization=kind == "gaussian",
                                  uniform_dequantization=kind == "uniform")
    ref = j_data_transform(jcfg, jnp.asarray(x), key)
    draw = (jax.random.normal if kind == "gaussian" else jax.random.uniform)(key, x.shape)
    out = data_transform(pc.from_fields(jcfg), torch.from_numpy(x),
                         noise=torch.from_numpy(np.asarray(draw)))
    _close(out, ref, rtol=0, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    drawn = data_transform(pc.from_fields(jcfg), torch.from_numpy(x), g)
    assert drawn.shape == x.shape and not torch.equal(drawn, torch.from_numpy(x))


def test_q_sample_matches_jax():
    rng = np.random.RandomState(52)
    x0, noise = rng.rand(3, 8, 8, 1).astype(np.float32), rng.randn(3, 8, 8, 1).astype(np.float32)
    sched_j, sched_t = j_make_schedule(), make_schedule()
    for t in (np.array(417), np.array([0, 500, 999])):
        ref = j_q_sample(sched_j, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
        out = q_sample(sched_t, torch.from_numpy(x0), torch.from_numpy(t),
                       torch.from_numpy(noise))
        _close(out, ref, rtol=0, atol=1e-6)


# ------------------------------------------------ config and routing ------


def test_experiment_config_carries_across():
    jcfg = jc.audio_visual_experiment(optim=jc.OptimConfig(lr=3e-4),
                                      training=jc.TrainingConfig(ema=True))
    pcfg = pc.from_fields(jcfg)
    assert pcfg.optim.lr == 3e-4 and pcfg.training.ema and pcfg.training.ema_rate == 0.9999
    assert pcfg.model == pc.from_fields(jcfg.model)
    assert pcfg.model.decoder.drop_path_rate == (0.15,) * 4
    assert pcfg.model.decoder.dropout == 0.1 and pcfg.model.decoder.skip_dead_frames_train
    assert pcfg.data_transform.gaussian_dequantization
    assert pcfg == pc.audio_visual_experiment(optim=pc.OptimConfig(lr=3e-4),
                                              training=pc.TrainingConfig(ema=True))


def _small_decoder():
    cfg = pc.SalUNetConfig(img_size=(64, 96))
    rng = np.random.RandomState(53)
    feats = [torch.from_numpy(rng.randn(1, 8, 2 * 2 ** i, 3 * 2 ** i, c).astype(np.float32))
             for i, c in enumerate((768, 384, 192, 96))]
    audio = torch.from_numpy(rng.randn(1, 9, 2, 3, 512).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 64, 96, 1).astype(np.float32))
    return SalUNet(cfg, with_audio=True), (x, torch.zeros(1), feats, audio)


def test_decoder_takes_k3_at_eval_only(monkeypatch):
    calls = []
    real = mlp_ops.block_tail
    monkeypatch.setattr(mlp_ops, "block_tail", lambda *a, **k: calls.append(1) or real(*a, **k))
    model, args = _small_decoder()
    with torch.no_grad():
        model(*args)
    assert len(calls) == 4
    calls.clear()
    out = model(*args, train=True, generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert not calls
    assert model.invpt_decoder.mid_stages[0].blocks[0].mlp.fc1.weight.grad is not None
    with pytest.raises(RuntimeError, match="eval-only"):  # eval with grad: K3 refuses
        model(*args)


@pytest.mark.parametrize("train_cut", [True, False])
def test_dead_frame_cut_follows_skip_dead_frames_train(train_cut):
    cfg = pc.SalUNetConfig(skip_dead_frames_train=train_cut)
    model = SalUNet(cfg, with_audio=False).invpt_decoder
    assert [model.keep_frames(i) for i in range(4)] == [5, 5, 5, 5]
    assert [model.keep_frames(i, train=True) for i in range(4)] == (
        [5, 5, 5, 5] if train_cut else [None, None, None, 5])
    no_cut = SalUNet(dataclasses.replace(cfg, skip_dead_frames_all=False), False).invpt_decoder
    assert [no_cut.keep_frames(i, train=True) for i in range(4)] == [None, None, None, 5]


# ---------------------------------------------------- train and eval steps ---


def _tiny_experiment(**training):
    model = pc.ModelConfig(visual=pc.MViTConfig.tiny(spatial_size=(64, 96)),
                           decoder=pc.SalUNetConfig(img_size=(64, 96)))
    return pc.ExperimentConfig(model=model, training=pc.TrainingConfig(**training))


def _tiny_batch(seed):
    g = torch.Generator().manual_seed(seed)
    return {"rgb": torch.randn(2, 16, 64, 96, 3, generator=g),
            "salmap": torch.rand(2, 64, 96, 1, generator=g),
            "valid": torch.tensor([1.0, 0.0])}


def test_train_step_draws_from_its_generator_and_keeps_an_ema():
    """Two runs of a step from the same state with equally seeded
    generators agree exactly (dequantization, timestep, x_T noise and the
    decoder's dropout and DropPath masks all come from the generator); a
    third seed differs; the EMA shadow follows ema_rate."""
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    cfg = _tiny_experiment(ema=True, ema_rate=0.5)
    assert cfg.model.decoder.dropout > 0 and cfg.model.decoder.drop_path_rate[0] > 0
    batch = _tiny_batch(54)
    runs = []
    for seed in (1, 1, 2):
        model = build_model(cfg.model, seed=0, device="cpu", train=True)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = make_optimizer(model, cfg.optim, steps_per_epoch=10, n_epochs=2)
        m = make_train_step(model, make_schedule(), cfg)(opt, batch,
                                                         torch.Generator().manual_seed(seed))
        runs.append((float(m["total"]), float(m["grad_norm"])))
        for n, p in model.named_parameters():
            torch.testing.assert_close(opt.ema[n], 0.5 * start[n] + 0.5 * p.detach())
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(np.isfinite(r).all() and r[0] > 0 for r in runs)


def test_eval_step_scores_the_sampled_maps_over_the_valid_mask():
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.train.train_step import make_eval_step

    cfg = _tiny_experiment()
    model = build_model(cfg.model, seed=0, device="cpu")
    batch = _tiny_batch(55)
    noise = torch.randn(2, 64, 96, 1, generator=torch.Generator().manual_seed(3))
    scores, pred = make_eval_step(model, make_schedule(), cfg)(batch, noise=noise)
    ref = sample_saliency(model, make_schedule(), cfg.sampling, cfg.data_transform,
                          batch["rgb"], noise=noise)
    torch.testing.assert_close(pred, ref, rtol=0, atol=0)
    expect = tl.eval_scores(ref, batch["salmap"], mask=batch["valid"])
    assert set(scores) == set(expect)
    for k in expect:
        torch.testing.assert_close(scores[k], expect[k], rtol=0, atol=0)
    # the invalid sample does not count
    first = tl.eval_scores(ref[:1], batch["salmap"][:1])
    torch.testing.assert_close(scores["total"], first["total"], rtol=1e-6, atol=1e-6)
