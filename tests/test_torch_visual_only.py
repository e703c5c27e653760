"""The visual-only model (`ModelConfig.visual_only()`, the DHF1k visual
pretraining model: MViT and the SalUNet without an audio branch) through
the port's `sample_saliency` and training step, against the JAX
package's, f32 on the CPU, at small sizes.

Same weights through `bridge.py`, same numpy inputs, the noise and draws
JAX makes recomputed and handed to the port, as in
tests/test_torch_e2e.py and tests/test_torch_train_step.py; the batch
has no "audio" key and the decoder runs with_audio=False. Tolerances as
there: the map to 1e-4 (MViT tiny at 64x96, DDIM NFE 1, in the default
layout and in the token-concat layout through K12, JAX with its Pallas
kernel in interpret mode); one training step (the 7-block
`MViTConfig.dryrun()` at 64x96, to keep the JAX compile short; dropout
and DropPath 0) with the loss to 1e-5 and every gradient leaf held as
`assert_gradient_leaves_match` holds it: the port's f32 step and JAX's
each within their own f32 rounding of the port's f64 step, the two
within four times the larger of those gaps, and here also JAX's gradient
in f64 (`jax_step_grads_f64`) against the port's f64 step. At 64x96 the
CvT key pooling keeps one key, so the decoder attention's q and k leaves
get a zero gradient, which the leaf check holds to 1e-6 of the largest;
the AV step tests need 128x96 only for the audio branch, which this
model lacks. Every step takes the ReLU branches of the port's f64 step
(`ReluBranches` in tests/test_torch_train_step.py; the port's f32 step
differs from them at 4 ReLU inputs, each within f32 rounding of zero).
They read, relative L2 per leaf, median (worst), max|d| / max|g| worst:
port f32 vs port f64 6.4e-6 (8.2e-6), 9.8e-6; JAX f32 vs port f64 7.8e-6
(1.0e-5), 1.6e-5; port f32 vs JAX f32 7.0e-6 (9.2e-6), 1.6e-5; port f64
vs JAX f64 1.2e-6 (1.9e-6), 2.4e-6. The f64 check bounds the two f64
gradients by 1e-5 relative L2 and 2e-5 max|d| / max|g| per leaf: five
times what it reads (JAX's f32 islands: the target, the timestep
embedding, the logits head, MViT's pooling). Without the shared branches
the pair read 2.7e-3 (1.2e-2 peak) on one CPU: the islands' f32 rounding
put decoder ReLU inputs that lie within f32 rounding of zero (the
smallest at 3.4e-9 of its tensor's largest) on the other side, and the
batch-statistics BatchNorms above them spread the jump over every leaf
(ROADMAP.md, F4). JAX's f64 step
takes minutes on a CPU. The port's steps run on one torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
from diff_sal_tpu.inference import sample_saliency as j_sample
from diff_sal_tpu.train.optim import make_optimizer as j_make_optimizer
from diff_sal_tpu.train.train_step import create_train_state
from diff_sal_tpu.train.train_step import make_train_step as j_make_train_step
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.diffusion.schedule import make_schedule
from diff_sal_tpu_torch.inference import sample_saliency
from diff_sal_tpu_torch.models.diff_model import build_model
from diff_sal_tpu_torch.train.optim import make_optimizer
from diff_sal_tpu_torch.train.train_step import make_train_step
from test_torch_models import full_model_variables, port_model
from test_torch_train_step import (ReluBranches, _stash_grads, assert_gradient_leaves_match,
                                   jax_step_grads_f64, port_f32_step, port_f64_step)

B = 2


def visual_only(hw, mvit=jc.MViTConfig.tiny, **visual) -> jc.ModelConfig:
    return dataclasses.replace(
        jc.ModelConfig.visual_only(), visual=mvit(spatial_size=hw, **visual),
        decoder=jc.SalUNetConfig(img_size=hw, dropout=0.0, drop_path_rate=(0.0,) * 4))


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("visual", [{}, {"cls_stream": False, "use_pallas_attention": True}],
                         ids=["cls_stream", "token_concat"])
def test_visual_only_sample_saliency_matches_jax(visual):
    cfg = visual_only((64, 96), **visual)
    jmodel, variables = full_model_variables(cfg, seed=41)
    rgb = np.random.RandomState(42).randn(B, 16, 64, 96, 3).astype(np.float32)
    sampling, data_cfg = jc.SamplingConfig(), jc.DataTransformConfig()
    key = jax.random.PRNGKey(43)
    sched = j_make_schedule()
    ref = jax.jit(lambda v, r: j_sample(jmodel, v, sched, sampling, data_cfg, r, None, key))(
        variables, rgb)
    noise = jax.random.normal(jax.random.split(key, 3)[1], (B, 64, 96, 1))

    model = port_model(cfg, variables)
    assert model.audio_net is None and model.spatiotemp_net is None
    assert model.cfg.visual.cls_stream == visual.get("cls_stream", True)
    out = sample_saliency(model, make_schedule(), pc.from_fields(sampling),
                          pc.from_fields(data_cfg), torch.from_numpy(rgb),
                          noise=torch.from_numpy(np.array(noise)))
    assert tuple(out.shape) == (B, 64, 96, 1) and float(out.std()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def step():
    """One JAX step, JAX's f64 gradient and the port's f32 and f64 steps of
    the visual-only model from the same weights, batch and draws."""
    hw = (64, 96)
    cfg = jc.ExperimentConfig(model=visual_only(hw, jc.MViTConfig.dryrun),
                              optim=jc.OptimConfig(lr=1e-4))
    jmodel, variables = full_model_variables(cfg.model, seed=44)
    rng = np.random.RandomState(45)
    batch = {"rgb": rng.randn(B, 16, *hw, 3).astype(np.float32),
             "salmap": rng.rand(B, *hw, 1).astype(np.float32)}
    key = jax.random.PRNGKey(46)
    sched = j_make_schedule()
    k_deq, k_t, k_noise, _ = jax.random.split(key, 4)
    shape = (B, *hw, 1)
    draws = {"deq": jax.random.normal(k_deq, shape), "noise": jax.random.normal(k_noise, shape),
             "t": jax.random.randint(k_t, (), 0, sched.num_timesteps)}
    branches = ReluBranches()
    ref64 = port_f64_step(cfg, variables, batch, draws, branches)
    tx = optax.chain(_stash_grads(), j_make_optimizer(cfg.optim, steps_per_epoch=4, n_epochs=2))
    state = create_train_state(jmodel, variables, tx)
    with ReluBranches.pinned_jax(branches):
        new_state, metrics = jax.jit(j_make_train_step(jmodel, sched, cfg))(
            state, jax.tree.map(jnp.asarray, batch), key)
    grads = bridge.state_dict_from_flax({"params": jax.device_get(new_state.opt_state[0])},
                                        cfg.model.visual.num_layers)
    jax64 = jax_step_grads_f64(cfg, variables, batch, key, int(draws["t"]), branches)
    model, port_metrics, _ = port_f32_step(cfg, variables, batch, draws, branches)
    print(f"ReLU inputs on the other side of zero from the f64 step's: port f32 "
          f"{branches.flips}")
    return {k: float(v) for k, v in metrics.items()}, grads, model, port_metrics, ref64, jax64


def test_visual_only_train_step_loss_matches_jax(step):
    jax_metrics, _, model, metrics, _, _ = step
    assert model.audio_net is None
    for k in ("total", "main"):
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_metrics["grad_norm"], rtol=1e-4)
    assert float(metrics["total"]) > 0


def test_visual_only_train_step_gradients_match_jax(step):
    _, grads, model, _, ref64, jax64 = step
    assert_gradient_leaves_match(grads, model, ref64["grads"], min_leaves=250, jax64=jax64,
                                 f64_bound=(1e-5, 2e-5))
    for sub in ("visual_net", "decoder_net"):
        assert any(p.grad is not None and float(p.grad.abs().max()) > 0
                   for p in getattr(model, sub).parameters()), sub


def test_bf16_layouts_give_the_same_step_on_the_cpu():
    """The visual-only step in bf16 through the plain versions, in both MViT
    layouts from the same weights, batch, draws and dropout masks (64x96,
    the decoder's dropout and DropPath on, as in the full recipe). The two
    layouts compute one function but round at other points in bf16, so
    their gradients differ as two bf16 runs do: this is the comparison
    `chip_smoke.py` phase 9 makes at full width on the card, and its
    cosine bound (`LAYOUT_GRAD_COS`) rests on what it reads here, printed
    with -s: cosine per sub-network >= 0.9. It read MViT 0.978, decoder
    0.983 (relative L2 0.24 and 0.20, the bf16 floor of
    tests/test_torch_train_step.py), losses within 1.3e-4 relative."""
    hw = (64, 96)
    base = pc.ModelConfig(visual=pc.MViTConfig.tiny(spatial_size=hw),
                          decoder=pc.SalUNetConfig(img_size=hw), compute_dtype="bfloat16")
    sd = None
    g = torch.Generator().manual_seed(47)
    batch = {"rgb": torch.randn(B, 16, *hw, 3, generator=g),
             "salmap": torch.rand(B, *hw, 1, generator=g)}
    draws = {"deq": torch.randn(B, *hw, 1, generator=g),
             "noise": torch.randn(B, *hw, 1, generator=g), "t": torch.tensor(300)}
    losses, grads = [], []
    for cls_stream in (True, False):
        cfg = dataclasses.replace(base, visual=dataclasses.replace(base.visual,
                                                                   cls_stream=cls_stream))
        m = build_model(cfg, seed=48, device="cpu", train=True)
        if sd is None:
            sd = {k: v.clone() for k, v in m.state_dict().items()}
        m.load_state_dict(sd)
        ecfg = pc.ExperimentConfig(model=cfg)
        met = make_train_step(m, make_schedule(), ecfg)(
            make_optimizer(m, ecfg.optim, 10, 2), batch, torch.Generator().manual_seed(49),
            draws=draws)
        losses.append(float(met["total"]))
        grads.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    report = {}
    for sub in ("visual_net", "decoder_net"):
        a, b = (torch.cat([gr[n].flatten() for n in sorted(gr) if n.startswith(sub)])
                for gr in grads)
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        report[sub] = (cos, float((a - b).norm() / b.norm()))
        assert cos >= 0.9, (sub, cos)
    print(f"bf16 layouts on the CPU: losses {losses}, (cosine, relative L2) {report}")
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-2)
