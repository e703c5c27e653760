"""The training slice as a whole: one step of the port's `train_step`
against one step of the JAX package's, f32 on the CPU.

The model is the small AV config at 128x96 (MViT tiny, VGGish,
AudioAttnNet, SalUNet; audio (B, 9, 64, 48, 1)): at that size the
coarsest video grid is (4, 3), so the CvT key pooling keeps more than one
key and every sub-network, AudioAttnNet included, gets a gradient (at
64x96 one key is left and the audio branch's gradient is zero by
construction, tests/test_train.py:138-141). Decoder dropout and DropPath
are 0 on both sides; JAX runs without Pallas attention. The weights are
carried across by `bridge.py`, and JAX's dequantization noise, shared
timestep and x_T noise are recomputed from its `split(rng, 4)` and handed
to the port. One JAX jit per module-scoped fixture (two in this file, one in
test_torch_train_step_full_frames.py, so no more than two of these
compiles run at once on the test workers); the raw gradients come out
of the JAX step through an optax stage that stores them in the optimizer
state.

Tolerances. The loss: rtol 1e-5 (same f32 function, other summation
order). The gradients cannot agree to 1e-6 here: at random weights f32
rounding moves each leaf's gradient by ~1e-5. The fixture shows it: it
runs the port's step once more in f64 (every op in f64, the schedule's f32
coefficients shared), first, and the other steps take that step's ReLU
branches (`ReluBranches`: a few of the decoder's ReLU inputs lie within
f32 rounding of zero, where the gradient jumps, and one element on the
other side moves every leaf by ~1e-3). The leaf test
(`assert_gradient_leaves_match`) holds each implementation to its own f32
rounding, measured against that f64 step: the port's f32 gradients and
JAX's, each within 5e-3 relative L2 and 3e-2 max|d| / max|g| on every
leaf, and the two within four times the larger of those two gaps (two
f32 errors, each up to twice the larger side's own). It prints, per leaf,
relative L2 median (worst) and max|d| / max|g| worst: port f32 vs port
f64 4.0e-6 (1.1e-5), 3.3e-5; JAX f32 vs port f64 6.5e-6 (1.7e-5), 3.1e-5;
port f32 vs JAX f32 7.8e-6 (1.9e-5), 5.7e-5 (full frames: 1.1e-5
(2.7e-5), 3.4e-5; 1.1e-5 (2.5e-5), 2.9e-5; 2.0e-5 (5.1e-5), 4.9e-5).
Before MViT's skip max pools were pinned too (fault F6, `ReluBranches`),
JAX's f32 gradient of `visual_net.blocks.8.proj.weight` sat 1.1e-3 from
the f64 step (max|d| / max|g| 1.3e-2; full frames 7.9e-4, 9.9e-3): one
pool window whose winner f32 rounding decides. Without the pinned branches the
same runs read ~1e-3 median on every pair, and which pairs crossed 5e-3
depended on the CPU (the summation order of its f32 convolutions decides
which side of zero those inputs land on): that was fault F4 (ROADMAP.md),
and it was also most of F2, JAX's f32 gap that an earlier bound blamed on
XLA:CPU's BatchNorm sums. That the port's f64 step is JAX's function is
checked in f64 by tests/test_torch_visual_only.py on its smaller model;
this model's f64 JAX step takes far longer and more memory than the suite
can give it. A wrong term shows as an error of order 1 in some leaf. A
leaf whose gradient is zero up to rounding (the key-side biases, which a
softmax ignores, and the bias before a batch-statistics BatchNorm) is
held to 1e-6 of the largest gradient.
The global gradient norm: rtol 1e-4. The BatchNorm running statistics:
1e-5 * max|stat| + 1e-6. The parameters after Adam's first step: each
element moves by lr * g / (|g| + eps) of its clipped gradient g, so where
both sides' clipped gradients have the same sign and exceed 100 * eps the
moves agree to 1% of lr, and the parameters to 2e-6; elsewhere the
direction is noise and they may differ by up to 2 * lr.

The step in bf16 (the `bf16_steps` fixture, `compute_dtype="bfloat16"`
on both sides; parameters, losses and optimizer state stay f32): at
random weights bf16 rounding moves the gradients far from the f64 ones,
for JAX as for the port, and these tests show that gap is the model's and
not the port's. Per sub-network the port's bf16 gradients may be no
further from f64 than JAX's are, up to a quarter more (two bf16 paths
that round at the same points but sum in other orders), and their
directions must agree with JAX's (cosine >= 0.9). They read, relative L2
to f64 for the port and for JAX: MViT 0.255 and 0.270, AudioAttnNet
0.222 and 0.214, the decoder 0.212 and 0.219, cosine 0.96-0.97 between
the two. The loss: the two bf16 losses and the f64 one within 1e-2
relative.
"""

import contextlib
import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from diff_sal_tpu import config as jc
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
from diff_sal_tpu.train.optim import make_optimizer as j_make_optimizer
from diff_sal_tpu.train.train_step import create_train_state
from diff_sal_tpu.train.train_step import make_train_step as j_make_train_step
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.diffusion.schedule import make_schedule
from diff_sal_tpu_torch.train.optim import make_optimizer
from diff_sal_tpu_torch.train.train_step import make_train_step
from test_torch_models import full_model_variables, port_model

HW = (128, 96)
B = 2
LR = 1e-4


def experiment(sdf_train: bool, compute_dtype: str = "float32") -> jc.ExperimentConfig:
    model = jc.ModelConfig(
        visual=jc.MViTConfig.tiny(spatial_size=HW),
        audio=jc.VGGishConfig(),
        spatiotemp=jc.AudioAttnConfig(),
        decoder=jc.SalUNetConfig(img_size=HW, dropout=0.0, drop_path_rate=(0.0,) * 4,
                                 skip_dead_frames_train=sdf_train),
        compute_dtype=compute_dtype,
    )
    return jc.ExperimentConfig(model=model, optim=jc.OptimConfig(lr=LR))


def _stash_grads() -> optax.GradientTransformation:
    """An optax stage that passes the gradients on and keeps them as its
    state, so the raw gradients leave the jitted step."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


@pytest.fixture(scope="module")
def steps():
    """skip_dead_frames_train on, the default; its other setting is
    tests/test_torch_train_step_full_frames.py."""
    return run_both(True)


@pytest.fixture(scope="module")
def bf16_steps():
    return run_both(True, "bfloat16")


def run_both(sdf_train: bool, compute_dtype: str = "float32"):
    """One JAX step and one port step from the same weights, batch and
    draws, and the port's step once more in f64: (JAX metrics, gradients
    and state after, as port state-dict entries; the port's model after
    its step; its metrics; its state before; the f64 step's loss and
    gradients). In f32 the f64 step runs first and the other two take its
    ReLU branches (`ReluBranches`)."""
    cfg = experiment(sdf_train, compute_dtype)
    jmodel, variables = full_model_variables(cfg.model, seed=31)
    rng = np.random.RandomState(32)
    batch = {"rgb": rng.randn(B, 16, *HW, 3).astype(np.float32),
             "salmap": rng.rand(B, *HW, 1).astype(np.float32),
             "audio": rng.randn(B, 9, HW[0] // 2, HW[1] // 2, 1).astype(np.float32)}
    key = jax.random.PRNGKey(33)
    sched = j_make_schedule()
    # the draws JAX makes inside the step (train_step.py:85-96)
    k_deq, k_t, k_noise, _ = jax.random.split(key, 4)
    shape = (B, *HW, 1)
    draws = {"deq": jax.random.normal(k_deq, shape), "noise": jax.random.normal(k_noise, shape),
             "t": jax.random.randint(k_t, (), 0, sched.num_timesteps)}
    branches = ReluBranches() if compute_dtype == "float32" else None
    ref64 = port_f64_step(cfg, variables, batch, draws, branches)
    tx = optax.chain(_stash_grads(), j_make_optimizer(cfg.optim, steps_per_epoch=4, n_epochs=2))
    state = create_train_state(jmodel, variables, tx)
    with ReluBranches.pinned_jax(branches):
        new_state, metrics = jax.jit(j_make_train_step(jmodel, sched, cfg))(
            state, jax.tree.map(jnp.asarray, batch), key)
    jax_out = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": bridge.state_dict_from_flax(
            {"params": jax.device_get(new_state.opt_state[0])}, cfg.model.visual.num_layers),
        "after": bridge.state_dict_from_flax(
            {"params": jax.device_get(new_state.params),
             "batch_stats": jax.device_get(new_state.batch_stats)},
            cfg.model.visual.num_layers),
    }
    return jax_out, *port_f32_step(cfg, variables, batch, draws, branches), ref64


@contextlib.contextmanager
def one_torch_thread():
    """The test workers share the CPU, and several processes of spinning
    OpenMP threads made the port's steps 20-70x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class ReluBranches:
    """The ReLU branches (and max-pool winners) of the port's f64 step,
    taken by every other step of a parity test.

    The decoder's ReLUs (UpEmbed, ReduceTemp, the final conv-BN-ReLU; the
    frozen VGGish's are recorded too, and no gradient crosses them) see
    some ten thousand pre-activations per step, and at these random weights
    a few of them lie within f32 rounding of zero (1-3 per ReLU; the
    smallest at 3.4e-9 of its tensor's largest, visual-only model). There
    the gradient is discontinuous: which side of zero an element lands on
    is decided by rounding, by the summation order of each implementation's
    f32 convolutions (which differs between CPUs) or by JAX's f32 islands in
    its f64 step. One element on the other side changes its gradient from g
    to 0, and the batch-statistics BatchNorm above it spreads that change
    over its whole channel and every leaf behind it: 1e-3 relative L2 on
    every leaf, from a single flipped element (measured: port f32 against
    port f64, visual-only model, median 1.4e-3 with three flips, 4.9e-6
    with the f64 branches taken). So the f64 step records the sign of
    every ReLU input, and the port's f32 step and JAX's steps (f32, and f64
    in `jax_step_grads_f64`) compute relu(x) as where(f64 sign, x, 0): the
    same function on every side, the ReLU's value changed only where the
    two signs differ, by at most that element's |x|. Elsewhere it is
    relu(x) exactly. The port's side checks that the signs differ only
    within `BAND` of the tensor's largest |x|, and each step must take the
    recorded ReLUs exactly, in order per shape.

    MViT's strided skip max pools (`models/mvit.py`, JAX's `nn.max_pool`)
    are the same kind of kink (fault F6, ROADMAP.md): the gradient goes to
    each window's winner, and where two entries of a window lie within f32
    rounding of each other the winner is decided by rounding. In the AV
    model one window of block 8's pool (of 147456) has its f64 top two
    1.9e-7 of the tensor's largest |x| apart, JAX's f32 step picks the
    other one (its inputs sit 1.3e-6 from f64), and that one element moved
    JAX's gradient of `visual_net.blocks.8.proj.weight` 1.1e-3 from f64
    (rel_pos tables of blocks 3-5 ~1e-3 too), 6.2e-6 with the f64 winners
    taken. So the f64 step also records each pool's winners, and the
    other steps take the recorded entry of every window (the max pool's
    value changed only where the two winners differ, by at most their
    difference; the port's side checks it is within `BAND`)."""

    BAND = 1e-4  # f32 forward values sit within ~1e-6 of f64 here

    def __init__(self, pools: bool = True):
        self.masks = []  # (shape, sign of the f64 input) in call order
        # (input shape (B, C, T, H, W), f64 winners) in call order; None: the
        # pools are left free (tests/f6_pool_winners.py measures them so)
        self.pools = [] if pools else None
        self.flips = []  # per pinned port step: elements whose sign differed

    def _queues(self):
        queues = {}
        for shape, m in self.masks:
            queues.setdefault(shape, []).append(m)
        return queues

    @contextlib.contextmanager
    def recording(self):
        relu, pool = torch.relu, F.max_pool3d

        def record(x):
            self.masks.append((tuple(x.shape), (x > 0).detach().numpy()))
            return relu(x)

        def record_pool(x, kernel, stride, padding, **kw):
            out, won = pool(x, kernel, stride, padding, return_indices=True)
            self.pools.append((tuple(x.shape), won.numpy()))
            return out
        torch.relu = record
        if self.pools is not None:
            F.max_pool3d = record_pool
        try:
            yield
        finally:
            torch.relu, F.max_pool3d = relu, pool

    @contextlib.contextmanager
    def pinned_torch(self):
        queues, relu, flips = self._queues(), torch.relu, [0]
        pools, pool = list(self.pools or []), F.max_pool3d

        def pinned(x):
            m = torch.from_numpy(queues[tuple(x.shape)].pop(0))
            off = m != (x > 0)
            if bool(off.any()):
                top = float(x.detach().abs().max())
                assert float(x.detach()[off].abs().max()) <= self.BAND * top, tuple(x.shape)
                flips[0] += int(off.sum())
            return torch.where(m, x, torch.zeros((), dtype=x.dtype))

        def pinned_pool(x, kernel, stride, padding, **kw):
            shape, won = pools.pop(0)
            assert shape == tuple(x.shape), (shape, tuple(x.shape))
            out = pool(x, kernel, stride, padding)
            B, C = shape[:2]
            got = x.reshape(B, C, -1).gather(2, torch.from_numpy(won).reshape(B, C, -1))
            got = got.reshape(out.shape)
            off = got != out
            if bool(off.any()):
                top = float(x.detach().abs().max())
                assert float((out - got).detach()[off].abs().max()) <= self.BAND * top, shape
                flips[0] += int(off.sum())
            return got
        torch.relu = pinned
        if self.pools is not None:
            F.max_pool3d = pinned_pool
        try:
            yield
        finally:
            torch.relu, F.max_pool3d = relu, pool
        assert not any(queues.values()), "a recorded ReLU was not taken"
        assert not pools, "a recorded max pool was not taken"
        self.flips.append(flips[0])

    @staticmethod
    @contextlib.contextmanager
    def pinned_jax(branches):
        """JAX's steps traced with the recorded branches (flax's `nn.relu`,
        which the JAX package's modules call); a no-op without them."""
        if branches is None:
            yield
            return
        queues, relu = branches._queues(), flax_nn.relu
        pools, pool = list(branches.pools or []), flax_nn.max_pool

        def pinned(x):
            m = queues[tuple(x.shape)].pop(0)
            return jnp.where(m, x, jnp.zeros((), x.dtype))

        def pinned_pool(x, window_shape, strides=None, padding="VALID"):
            out = pool(x, window_shape, strides=strides, padding=padding)
            if x.ndim != 5:  # VGGish's 2-D pools: no gradient reaches them
                return out
            shape, won = pools.pop(0)  # (B, C, T', H', W') indices into T H W
            B, C = x.shape[0], x.shape[-1]
            assert (B, C) + tuple(x.shape[1:4]) == shape, (shape, x.shape)
            won = jnp.asarray(np.moveaxis(won, 1, -1).reshape(B, -1, C))
            return jnp.take_along_axis(x.reshape(B, -1, C), won, axis=1).reshape(out.shape)
        flax_nn.relu = pinned
        if branches.pools is not None:
            flax_nn.max_pool = pinned_pool
        try:
            yield
        finally:
            flax_nn.relu, flax_nn.max_pool = relu, pool
        assert not any(queues.values()), "a recorded ReLU was not taken"
        assert not pools, "a recorded max pool was not taken"


def port_f64_step(cfg, variables, batch, draws, branches=None):
    """The port's step in f64 (every op in f64, the schedule's f32
    coefficients shared), the reference for f32 rounding in the gradients:
    its loss and gradients. With `branches` it records its ReLU branches."""
    model64 = port_model(dataclasses.replace(cfg.model, compute_dtype="float32"),
                         variables).double()
    opt64 = make_optimizer(model64, pc.from_fields(cfg.optim), steps_per_epoch=4, n_epochs=2)
    with one_torch_thread(), (branches.recording() if branches else contextlib.nullcontext()):
        metrics64 = make_train_step(model64, make_schedule(), pc.from_fields(cfg))(
            opt64, {k: torch.from_numpy(v).double() for k, v in batch.items()},
            draws={k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    return {"total": float(metrics64["total"]),
            "grads": {n: p.grad for n, p in model64.named_parameters() if p.grad is not None}}


def port_f32_step(cfg, variables, batch, draws, branches=None):
    """The port's step from the same weights, batch and draws, with the
    f64 step's ReLU branches where given: (model after the step, metrics,
    state before)."""
    model = port_model(cfg.model, variables)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, pc.from_fields(cfg.optim), steps_per_epoch=4, n_epochs=2)
    step = make_train_step(model, make_schedule(), pc.from_fields(cfg))
    with one_torch_thread(), (branches.pinned_torch() if branches else contextlib.nullcontext()):
        port_metrics = step(opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                            draws={k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    return model, port_metrics, before


def test_loss_and_metrics_match_jax(steps):
    jax_out, _, metrics, _, _ = steps
    for k in ("total", "main", "cc", "sim", "nss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), jax_out["metrics"][k],
                                   rtol=1e-4 if k == "grad_norm" else 1e-5, atol=1e-12,
                                   err_msg=k)
    assert float(metrics["total"]) > 0 and float(metrics["grad_norm"]) > 0


def test_every_gradient_leaf_matches_jax(steps):
    jax_out, model, _, _, ref64 = steps
    assert_gradient_leaves_match(jax_out["grads"], model, ref64["grads"], min_leaves=400)


def jax_step_grads_f64(cfg, variables, batch, key, t, branches=None):
    """JAX's gradient of its train-step loss in f64, as port state-dict
    entries: `jax.enable_x64`, the model at compute_dtype "float64", the
    variables and the batch in f64, and the loss function of
    diff_sal_tpu/train/train_step.py:84-118 written out with JAX's own
    data_transform, q_sample, model and training_loss. Its draws come from
    the step's key, split as the step splits it; the timestep `t` is handed
    in (under x64 `randint` draws other bits). As in the port's f64 step the
    schedule's f32 coefficients are shared. The JAX model's explicit float32
    islands (the dequantised target, the timestep embedding, the logits
    head, MViT's pooling) stay f32. With `branches` its ReLUs take the
    port's f64 branches (`ReluBranches`)."""
    from diff_sal_tpu.data.transforms import data_transform
    from diff_sal_tpu.diffusion.schedule import q_sample
    from diff_sal_tpu.models.diff_model import VideoSaliencyModel
    from diff_sal_tpu.train.losses import training_loss
    from diff_sal_tpu.train.train_step import audio_hw_for, resolve_audio

    def f64(x):
        x = np.asarray(x)
        return x.astype(np.float64) if x.dtype == np.float32 else x

    sched = j_make_schedule()
    with jax.enable_x64(True):
        model = VideoSaliencyModel(dataclasses.replace(cfg.model, compute_dtype="float64"))
        v64 = jax.tree.map(f64, variables)
        k_deq, _, k_noise, k_drop = jax.random.split(key, 4)

        def loss(params, batch):
            x0 = data_transform(cfg.data_transform, batch["salmap"].astype(jnp.float32), k_deq)
            noise = jax.random.normal(k_noise, x0.shape, x0.dtype)
            tv = jnp.full((x0.shape[0],), t)
            x_noisy = q_sample(sched, x0.astype(jnp.float64), tv, noise.astype(jnp.float64))
            data = {"rgb": batch["rgb"], "input": x_noisy}
            audio = resolve_audio(batch, audio_hw_for(cfg))
            if audio is not None:
                data["audio"] = audio
            pred, _ = model.apply({"params": params, "batch_stats": v64["batch_stats"]}, data,
                                  tv.astype(jnp.float32), True, mutable=["batch_stats"],
                                  rngs={"dropout": k_drop})
            return training_loss(cfg.loss, pred, x0.astype(jnp.float64))["total"]

        assert cfg.training.training_target == "x0"
        with ReluBranches.pinned_jax(branches):
            grads = jax.jit(jax.grad(loss))(v64["params"], jax.tree.map(f64, batch))
        return bridge.state_dict_from_flax({"params": jax.device_get(grads)},
                                           cfg.model.visual.num_layers)


PORT_F32_L2, PORT_F32_PEAK = 5e-3, 3e-2  # an implementation's own f32 rounding, at most


def assert_gradient_leaves_match(jax_grads, model, grads64, min_leaves: int, jax64=None,
                                 f64_bound=None):
    """Every gradient leaf of the port's f32 step against JAX's, each side
    first held to its own f32 rounding (the module docstring). `grads64`,
    the port's f64 step, is the reference; with `jax64`, JAX's f64
    gradients, the two f64 computations are held to `f64_bound` (relative
    L2, max|d| over max|g|) on every leaf. Returns the per-leaf worst
    values that the docstrings quote."""
    top = max(float(v.abs().max()) for v in jax_grads.values())
    # per leaf: relative L2 and max|d| / max|g| of (port f32, JAX f32),
    # (port f32, f64) and (JAX f32, f64), and (port f64, JAX f64)
    gap = {"port-jax": [], "port-f64": [], "jax-f64": [], "f64-f64": []}
    peak = {k: [] for k in gap}
    for name, p in model.named_parameters():
        ref = jax_grads[name].numpy()
        if name.startswith("audio_net."):  # frozen: no gradient at all in the port
            assert p.grad is None and not p.requires_grad, name
            assert not np.any(ref), name
            continue
        if p.grad is None:  # off the graph (the unused finest pyramid scale's norm)
            assert not np.any(ref), name
            continue
        got = p.grad.numpy()
        if float(np.abs(ref).max()) <= 1e-6 * top:
            assert float(np.abs(got).max()) <= 1e-6 * top, name
            continue
        g64 = grads64[name].numpy()
        pairs = {"port-jax": (got, ref), "port-f64": (got, g64), "jax-f64": (ref, g64)}
        if jax64 is not None:
            pairs["f64-f64"] = (g64, jax64[name].numpy())
        for k, (a, b) in pairs.items():
            gap[k].append((float(np.linalg.norm(a - b) / np.linalg.norm(b)), name))
            peak[k].append((float(np.abs(a - b).max() / np.abs(b).max()), name))
    assert len(gap["port-jax"]) > min_leaves
    q = lambda v: f"median {np.median([x for x, _ in v]):.2e} max {max(v)[0]:.2e} ({max(v)[1]})"  # noqa: E731,E501
    print(f"gradient leaves ({len(gap['port-jax'])}): relative L2 / max|d| over max|g|: "
          + "; ".join(f"{k} {q(gap[k])} / {q(peak[k])}" for k in gap if gap[k]))
    worst = {k: (max(gap[k]), max(peak[k])) for k in gap if gap[k]}
    # each implementation's own f32 rounding, shown against the f64 step
    for k in ("port-f64", "jax-f64"):
        (l2, n1), (pk, n2) = worst[k]
        assert l2 <= PORT_F32_L2 and pk <= PORT_F32_PEAK, (k, worst[k])
    # two f32 errors, each up to twice the larger side's own
    floor = max(worst["port-f64"][0][0], worst["jax-f64"][0][0])
    floor_peak = max(worst["port-f64"][1][0], worst["jax-f64"][1][0])
    assert worst["port-jax"][0][0] <= 4 * floor, (worst["port-jax"], floor)
    assert worst["port-jax"][1][0] <= 4 * floor_peak, (worst["port-jax"], floor_peak)
    if jax64 is not None:
        assert worst["f64-f64"][0][0] <= f64_bound[0], (worst["f64-f64"], f64_bound)
        assert worst["f64-f64"][1][0] <= f64_bound[1], (worst["f64-f64"], f64_bound)
    return worst


def test_every_sub_network_gets_a_gradient(steps):
    _, model, _, _, _ = steps
    for sub in ("visual_net", "spatiotemp_net", "decoder_net"):
        mod = getattr(model, sub)
        assert any(p.grad is not None and float(p.grad.abs().max()) > 0
                   for p in mod.parameters()), sub
    for name in ("visual_net.blocks.0.attn.rel_pos_h", "visual_net.blocks.0.attn.qkv.weight",
                 "visual_net.blocks.0.attn.norm_q.weight", "visual_net.blocks.0.attn.proj.weight",
                 "visual_net.blocks.1.attn.pool_k.weight"):
        assert float(model.get_parameter(name).grad.abs().max()) > 0, name


def test_batch_stats_after_the_step_match_jax(steps):
    jax_out, model, _, before, _ = steps
    sd = model.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 14  # 3 UpEmbeds x 2 BNs + mt_proj, mean and var each
    for k in names:
        ref = jax_out["after"][k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()) + 1e-6, err_msg=k)
        assert not torch.equal(sd[k], before[k]), k  # batch statistics moved them
        counter = k.rsplit(".", 1)[0] + ".num_batches_tracked"
        assert torch.equal(sd[counter], before[counter])


def test_parameters_after_the_adam_step_match_jax(steps):
    jax_out, model, metrics, before, _ = steps
    clip = min(1.0, 1.0 / float(metrics["grad_norm"]))  # grad_clip 1.0
    n_sure = n_all = 0
    for name, p in model.named_parameters():
        ref = jax_out["after"][name].numpy()
        got = p.detach().numpy()
        if name.startswith("audio_net."):
            assert torch.equal(p.detach(), before[name]), name
            continue
        gj = jax_out["grads"][name].numpy() * clip
        gp = np.zeros_like(gj) if p.grad is None else p.grad.numpy() * clip
        sure = (np.sign(gj) == np.sign(gp)) & (np.minimum(np.abs(gj), np.abs(gp)) > 1e-6)
        d = np.abs(got - ref)
        assert float(d[sure].max(initial=0)) <= 2e-6, name
        assert float(d.max(initial=0)) <= 2 * LR * (1 + 1e-3), name
        n_sure, n_all = n_sure + int(sure.sum()), n_all + sure.size
    assert n_sure > 0.5 * n_all, (n_sure, n_all)
    # the CvT projections act on a T=1 grid: their off-centre weights get
    # exactly zero gradient and stay at zero through Adam
    w = model.get_parameter("decoder_net.invpt_decoder.mid_stages.0.blocks.0.attn."
                            "conv_proj_q.conv.weight")
    assert float(w[:, :, 0].abs().max()) == 0.0 and float(w[:, :, 2].abs().max()) == 0.0
    assert float(w[:, :, 1].abs().max()) > 0.0


# ----------------------------------------------------------- bf16 step ---

SUBS = ("visual_net", "spatiotemp_net", "decoder_net")


def _flat(grads, sub, names):
    return np.concatenate([np.asarray(grads[n]).ravel() for n in names if n.startswith(sub)])


def test_bf16_loss_matches_jax_and_f64(bf16_steps):
    jax_out, _, metrics, _, ref64 = bf16_steps
    lj, lp = jax_out["metrics"]["total"], float(metrics["total"])
    assert np.isfinite(lp) and lp > 0
    np.testing.assert_allclose(lp, lj, rtol=1e-2)
    np.testing.assert_allclose(lp, ref64["total"], rtol=1e-2)
    np.testing.assert_allclose(lj, ref64["total"], rtol=1e-2)
    print(f"loss: port bf16 {lp:.6f}, JAX bf16 {lj:.6f}, port f64 {ref64['total']:.6f}")


def test_bf16_gradients_are_no_further_from_f64_than_jax(bf16_steps):
    jax_out, model, _, _, ref64 = bf16_steps
    grads64 = ref64["grads"]
    port = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    ref = {n: grads64[n].numpy() for n in port}
    jgrads = {n: jax_out["grads"][n].numpy() for n in port}
    names = sorted(port)
    report = {}
    for sub in SUBS:
        g64, gp, gj = (_flat(d, sub, names) for d in (ref, port, jgrads))
        e_port = float(np.linalg.norm(gp - g64) / np.linalg.norm(g64))
        e_jax = float(np.linalg.norm(gj - g64) / np.linalg.norm(g64))
        cos = float(gp @ gj / (np.linalg.norm(gp) * np.linalg.norm(gj)))
        report[sub] = (e_port, e_jax, cos)
        assert e_port <= 1.25 * e_jax, (sub, e_port, e_jax)
        assert cos >= 0.9, (sub, cos)
    print("bf16 gradients per sub-network (port vs f64, JAX vs f64, cosine port/JAX): "
          + ", ".join(f"{k} {a:.3e} {b:.3e} {c:.4f}" for k, (a, b, c) in report.items()))
