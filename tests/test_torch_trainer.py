"""The port's trainer, checkpoints and logging on the CPU.

Against the JAX package: the AV variant of JAX's `tiny_cfg`
(tests/test_trainer.py:26: MViT tiny at 64x96, B=2, plus VGGish and
AudioAttnNet, uint8 STAViS normalization) on a packed AV tree written by
`data/synthetic.write_packed_av_tree`: raw 16 kHz excerpts, so every step
runs the log-mel frontend. Three runs start from the same weights (the
bridge) and take 2 epochs of 2 steps, each followed by one validation
batch through DDIM NFE 1: the port's trainer in f64, JAX's trainer, and
the port's `train_av_splits` in f32. The RNGs differ, so the test wraps
each trainer's `train_step` / `eval_step`: JAX's takes the keys its
Trainer chains (checked), and the port's the draws JAX makes from them
(dequantization noise, shared timestep, x_T noise; `split(rng, 4)` as in
tests/test_torch_train_step.py). Dropout and DropPath are 0 on both
sides, since their masks cannot be handed across. The f64 run goes first
and records each call's ReLU branches and max-pool winners
(`ReluBranches`); every other run takes them (JAX's steps jitted with them
as arguments, `pinned_jax_step`), and each checks that its own branches
differ from them only within f32 rounding of the kink (faults F4, F6).

Port f32 is held to JAX f32 directly: every log value within 1e-4 of
max(|value|, 1), the lr column exactly, the same best epoch; Adam's
moments within 1e-3 relative L2 per tensor; the parameters and BatchNorm
statistics after each epoch within 2e-2 of JAX's update (relative L2:
Adam turns a gradient element whose sign rounding decides into a move of
2 lr, so the parameters cannot follow the gradients' 1e-4). The f64 run is
the check on each f32 side's rounding. The `slow` test also runs JAX's
trainer in f64 on the same branches and holds the port's f64 run to it: a
reference that shares no code with the port.

The port alone: an interrupted run resumed from its checkpoint ends bit
for bit where an uninterrupted one does (logs, parameters, buffers, Adam's
moments); `restore_best`, `warm_start`, `partial_load`'s counts against
JAX's on the same trees, `train_av_splits` on the packed tree, evaluation
with the EMA and map dumping, the checkpoint manager, and the logging and
debug helpers. The port's steps run on one torch thread.
"""

import csv
import dataclasses
import os
import shutil

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.data.loader import Loader as JLoader
from diff_sal_tpu.data.packed import PackedAVDataset as JPackedAV
from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
from diff_sal_tpu.train import checkpoint as jckpt
from diff_sal_tpu.train.trainer import Trainer as JTrainer
from diff_sal_tpu.train.train_step import create_train_state
from diff_sal_tpu.utils import logging as jlog
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.data.loader import Loader
from diff_sal_tpu_torch.data.packed import PackedAVDataset
from diff_sal_tpu_torch.data.synthetic import SyntheticAVDataset, write_packed_av_tree
from diff_sal_tpu_torch.train import checkpoint as pckpt
from diff_sal_tpu_torch.train.trainer import (TRAIN_COLUMNS, VAL_COLUMNS, Trainer,
                                              train_av_splits)
from diff_sal_tpu_torch.utils import debug as pdebug
from diff_sal_tpu_torch.utils import logging as plog
from test_torch_train_step import ReluBranches, one_torch_thread
from test_trainer import HW, tiny_cfg

B = 2
# (name, frames) per fold at 20 fps: 80 frames give two 90-frame-step
# windows (frames 1 and 75), so 4 train windows (2 steps of 2) and 2 test
FOLDS = {"train": (("v1", 80), ("v2", 80)), "test": (("v3", 80),)}
# port f32 against JAX f32 after 2 epochs x 2 steps: a log value, relative
# to max(|value|, 1); a tensor, relative L2 over JAX's update; Adam's
# moments, relative L2 (each test's docstring gives what it measured)
LOGS, PARAMS, MOMENTS = 1e-4, 2e-2, 1e-3
# how far each f32 run's tensors may lie from the port's f64 run, relative
# L2 over the update: the check on f32 rounding
F32_RUN = 2e-2
# the port's f64 run against JAX's f64 trainer (slow): as LOGS, PARAMS and
# MOMENTS; JAX's f32 islands keep the two f64 runs ~1e-5 apart
F64_LOGS, F64_PARAMS, F64_MOMENTS = 5e-6, 2e-3, 5e-4


def flax_like_variables(shapes, seed: int):
    """numpy values distributed as the flax modules' own initializers draw
    them: fan-in-scaled normal kernels, zero biases and BatchNorm means,
    unit norm scales and BatchNorm variances, N(0, 0.02) rel-pos tables
    and cls token."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("bias", "mean"):
            return np.zeros(s.shape, np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        r = rng.randn(*s.shape)
        if name.startswith("rel_pos") or name == "cls_token":
            return (0.02 * r).astype(np.float32)
        return (r / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def parity_cfg(audio: bool = False, **training) -> jc.ExperimentConfig:
    """JAX's tiny_cfg with uint8 STAViS normalization, decoder dropout and
    DropPath at 0, the audio branch when asked, and `training` overrides."""
    cfg = tiny_cfg()
    model = dataclasses.replace(
        cfg.model, uint8_norm="stavis",
        decoder=dataclasses.replace(cfg.model.decoder, dropout=0.0, drop_path_rate=(0.0,) * 4))
    if audio:
        model = dataclasses.replace(model, audio=jc.VGGishConfig(),
                                    spatiotemp=jc.AudioAttnConfig())
    return dataclasses.replace(
        cfg, model=model, training=dataclasses.replace(cfg.training, **training))


def read_log(path):
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("packed"))
    return root, write_packed_av_tree(root, HW, FOLDS, fps=20.0)


def jax_draws(key, shape, T):
    """The draws JAX's train step makes from its key (train_step.py:85-96)."""
    k_deq, k_t, k_noise, _ = jax.random.split(key, 4)
    return {"deq": torch.from_numpy(np.array(jax.random.normal(k_deq, shape))),
            "t": torch.tensor(int(jax.random.randint(k_t, (), 0, T))),
            "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, shape)))}


def trainer_keys(cfg, steps, evaluations):
    """The keys JAX's Trainer hands its steps (train/trainer.py:191-210,
    265-279): a chain from PRNGKey(seed + 1) split once per step, and per
    evaluation PRNGKey(0) split once per batch (one batch here)."""
    rng, train = jax.random.PRNGKey(cfg.training.seed + 1), []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        train.append(np.asarray(key))
    evaluation = np.asarray(jax.random.split(jax.random.PRNGKey(0))[1])
    return {"train": train, "eval": [evaluation] * evaluations}


def keep_in_memory(trainer):
    """Route the trainer's checkpoint saves into a dict (epoch -> payload,
    the state_dict cloned) instead of files: each checkpoint of this model
    is ~0.75 GB, and the parity runs need only the payloads. The files are
    exercised by the resume, restore_best and checkpoint-manager tests."""
    saved = {}

    def save(step, state):
        saved[step] = dict(state, state_dict={k: v.detach().clone()
                                              for k, v in state["state_dict"].items()})
    trainer.ckpt.save = save
    return saved


class PortRun:
    """A port trainer's results: the trainer, its workdir, best.json, and
    the payloads its checkpoint manager was handed (`keep_in_memory`)."""

    def __init__(self, trainer, saved):
        self.trainer = trainer
        self.workdir = trainer.workdir
        self.best = trainer.ckpt.best()
        self.steps = sorted(saved)
        self.params = [saved[step]["state_dict"] for step in self.steps]
        self.last = saved[self.steps[-1]]


def with_jax_draws(trainer, keys, f64=False):
    """Wrap the trainer's steps: the train step takes the draws JAX makes
    from each key, the eval step JAX's x_T noise. With `f64` the batch's
    rgb and audio reach the (double) model as f64, normalized and computed
    in f32 as JAX's f32 step does."""
    from diff_sal_tpu_torch.data.transforms import normalize_rgb_u8
    from diff_sal_tpu_torch.train.train_step import audio_hw_for, resolve_audio

    h, w = HW
    T = trainer.schedule.num_timesteps
    train = [jax_draws(k, (B, h, w, 1), T) for k in keys["train"]]
    noise = [torch.from_numpy(np.array(jax.random.normal(jax.random.split(k, 3)[1], (B, h, w, 1))))
             for k in keys["eval"]]
    step, evaluate = trainer.train_step, trainer.eval_step

    def cast(batch):
        if not f64:
            return batch
        out = dict(batch)
        out["rgb"] = normalize_rgb_u8(batch["rgb"], "stavis").double()
        audio = resolve_audio(out, audio_hw_for(trainer.cfg))
        out.pop("wave", None)
        if audio is not None:
            out["audio"] = audio.double()
        return out

    trainer.train_step = lambda opt, batch, gen: step(opt, cast(batch), gen, draws=train.pop(0))
    trainer.eval_step = lambda batch, gen: evaluate(cast(batch), gen, noise=noise.pop(0))
    return train, noise


def record_branches(trainer):
    """Wrap the trainer's steps so that each call records its ReLU
    branches and max-pool winners (`ReluBranches`, one per call)."""
    calls = {"train": [], "eval": []}

    def wrap(kind, fn):
        def call(*args):
            calls[kind].append(ReluBranches())
            with calls[kind][-1].recording():
                return fn(*args)
        return call

    trainer.train_step = wrap("train", trainer.train_step)
    trainer.eval_step = wrap("eval", trainer.eval_step)
    return calls


def take_branches(trainer, calls):
    """Wrap the trainer's steps so that each call takes the branches of the
    matching recorded call (`ReluBranches.pinned_torch`)."""
    left = {kind: list(c) for kind, c in calls.items()}

    def wrap(kind, fn):
        def call(*args):
            with left[kind].pop(0).pinned_torch():
                return fn(*args)
        return call

    trainer.train_step = wrap("train", trainer.train_step)
    trainer.eval_step = wrap("eval", trainer.eval_step)
    return left


def pinned_jax_step(fn, calls, keys):
    """JAX's train or eval step `fn`, jitted with the recorded calls' ReLU
    signs and max-pool winners as arguments, so that one compile serves
    every call and each call takes its own (what `ReluBranches.pinned_jax`
    does for a single step, where they are constants). Each call checks
    that the trainer hands it the expected key, and that JAX's own branches
    differ from the recorded ones only within `ReluBranches.BAND` of the
    tensor's largest |x| (reported by a host callback, which also works
    inside the eval step's scan)."""
    calls, keys, off = list(calls), list(keys), []

    def traced(state, batch, rng, relus, pools):
        queues, pools = {}, list(pools)
        for m in relus:
            queues.setdefault(tuple(m.shape), []).append(m)
        relu, pool = flax_nn.relu, flax_nn.max_pool

        def report(d, x):
            jax.debug.callback(lambda v: off.append(float(v)), d / jnp.abs(x).max())

        def pinned(x):
            m = queues[tuple(x.shape)].pop(0)
            report(jnp.where(m != (x > 0), jnp.abs(x), 0).max(), x)
            return jnp.where(m, x, jnp.zeros((), x.dtype))

        def pinned_pool(x, window_shape, strides=None, padding="VALID"):
            out = pool(x, window_shape, strides=strides, padding=padding)
            if x.ndim != 5:  # VGGish's 2-D pools: no gradient reaches them
                return out
            won = pools.pop(0)
            b, c = x.shape[0], x.shape[-1]
            got = jnp.take_along_axis(x.reshape(b, -1, c), won, axis=1).reshape(out.shape)
            report((out - got).max(), x)
            return got

        flax_nn.relu, flax_nn.max_pool = pinned, pinned_pool
        try:
            result = fn(state, batch, rng)
        finally:
            flax_nn.relu, flax_nn.max_pool = relu, pool
        assert not any(queues.values()) and not pools, "a recorded branch was not taken"
        return result

    step = jax.jit(traced)

    def call(state, batch, rng):
        assert np.array_equal(np.asarray(rng), keys.pop(0))
        b = calls.pop(0)
        pools = [np.moveaxis(won, 1, -1).reshape(shape[0], -1, shape[1]) for shape, won in b.pools]
        out = jax.block_until_ready(step(state, batch, rng, [m for _, m in b.masks], pools))
        jax.effects_barrier()
        assert off and max(off) <= ReluBranches.BAND, max(off)
        off.clear()
        return out

    return call


def jax_moments(state, layers):
    """Adam's count and moments in a JAX train state, the moments as port
    state-dict entries."""
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return {"count": int(adam[0].count), **{
        k: bridge.state_dict_from_flax({"params": jax.device_get(getattr(adam[0], k))}, layers)
        for k in ("mu", "nu")}}


def run_jax_trainer(cfg, workdir, root, config, variables, branches, keys):
    """JAX's Trainer on the packed tree from `variables`, its steps taking
    the recorded branches (`pinned_jax_step`); its per-epoch parameters and
    BatchNorm statistics, as port state-dict entries, kept in memory in
    place of its checkpoints."""
    from diff_sal_tpu.train.train_step import make_eval_step as j_eval, make_train_step as j_train

    train = JLoader(JPackedAV(root, config, "split1", True, datasets=["avad"]), B,
                    shuffle=True, num_workers=0)
    val = JLoader(JPackedAV(root, config, "split1", False, datasets=["avad"]), B,
                  shuffle=False, num_workers=0)
    assert len(train) == 2 and len(val) == 1
    jt = JTrainer(cfg, workdir, steps_per_epoch=2, n_epochs=2, use_mesh=False)
    # with the step counter as the jitted step returns it, so that the
    # second step does not compile the step again
    jt.state = jax.device_put(create_train_state(jt.model, variables, jt.tx).replace(
        step=jnp.asarray(0, jnp.int32)))
    jt.train_step = pinned_jax_step(j_train(jt.model, jt.schedule, cfg), branches["train"],
                                    keys["train"])
    jt.eval_step = pinned_jax_step(j_eval(jt.model, jt.schedule, cfg), branches["eval"],
                                   keys["eval"])
    params = []
    jt._save = lambda epoch: params.append(bridge.state_dict_from_flax(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats}),
        cfg.model.visual.num_layers))
    jt.fit(train, val, log_name="split1")
    return jt, params


@pytest.fixture(scope="module")
def runs(packed, tmp_path_factory):
    """The port's trainer in f64 (the reference for f32 rounding, and the
    branches every other run takes), JAX's trainer and the port's
    `train_av_splits` (f32), from the same weights with JAX's draws."""
    from diff_sal_tpu_torch.train.optim import make_optimizer_and_schedule

    root, config = packed
    cfg = parity_cfg(audio=True, log_freq=1, n_epochs_for_av_data=2)
    pcfg = pc.from_fields(cfg)
    work = tmp_path_factory.mktemp("runs")
    keys = trainer_keys(cfg, steps=4, evaluations=2)
    h, w = HW
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0), {
        "rgb": jnp.zeros((1, 16, h, w, 3)), "input": jnp.zeros((1, h, w, 1)),
        "audio": jnp.zeros((1, 9, h // 2, w // 2, 1))}, jnp.zeros((1,)))
    variables = flax_like_variables(shapes, seed=41)
    weights = bridge.state_dict_from_flax(variables, cfg.model.visual.num_layers)

    # the port in f64, first: it records each call's branches
    ref = Trainer(pcfg, str(work / "f64" / "split1"), steps_per_epoch=2, n_epochs=2,
                  device="cpu")
    ref.init_state()
    ref.model.double().load_state_dict(weights, strict=True)
    ref.optimizer, ref.lr_schedule = make_optimizer_and_schedule(ref.model, pcfg.optim, 2, 2)
    left = with_jax_draws(ref, keys, f64=True)
    branches = record_branches(ref)
    ref_saved = keep_in_memory(ref)
    train = Loader(PackedAVDataset(root, config, "split1", True), B, shuffle=True, num_workers=0)
    val = Loader(PackedAVDataset(root, config, "split1", False), B, shuffle=False, num_workers=0)
    with one_torch_thread():
        ref.fit(train, val, log_name="split1")
    assert not any(left) and [len(branches[k]) for k in ("train", "eval")] == [4, 2]

    # JAX, its state set from the numpy weights (no init compile)
    jt, jax_params = run_jax_trainer(cfg, str(work / "jax" / "split1"), root, config, variables,
                                     branches, keys)

    # the port's AV protocol, warm-started from all of those weights
    init_state, left, pinned, saved = Trainer.init_state, [], [], []

    def init_with_jax_draws(self, *a, **kw):
        init_state(self, *a, **kw)
        left.append(with_jax_draws(self, keys))
        pinned.append(take_branches(self, branches))
        saved.append(keep_in_memory(self))

    Trainer.init_state = init_with_jax_draws
    try:
        with one_torch_thread():
            # uint8_norm "imagenet": train_av_splits switches it for packed frames
            imagenet = dataclasses.replace(
                pcfg, model=dataclasses.replace(pcfg.model, uint8_norm="imagenet"))
            port = train_av_splits(imagenet, config, str(work / "port"), visual_best_params=weights,
                                   splits=("split1",), packed_root=root,
                                   loader_kwargs={"num_workers": 2}, device="cpu")["split1"]
    finally:
        Trainer.init_state = init_state
    assert left and not any(left[0]) and not any(pinned[0].values())
    flips = [b.flips for k in ("train", "eval") for b in branches[k]]
    print(f"ReLU inputs and pool winners on the other side from the f64 run's, per call "
          f"of the port's f32 run: {flips}")
    return {"jax": (jt, jax_params), "port": PortRun(port, saved[0]),
            "f64": PortRun(ref, ref_saved), "init": weights, "variables": variables,
            "branches": branches, "keys": keys, "cfg": cfg}


def _logs(workdir):
    return {name: read_log(os.path.join(workdir, name)) for name in ("split1.log", "split1_val.log")}


def test_trainer_logs_match_jax(runs):
    """Both TSV logs, value by value, port f32 against JAX f32: epoch, step
    and lr exactly, every other value within LOGS of max(|JAX's|, 1) (the
    scale keeps the near-zero val cc and nss from asking for more than f32
    gives). Each f32 side is also held to the port's f64 run at the same
    bound, as the check on its rounding. Measured (port - JAX, port - f64,
    JAX - f64): the loss at epoch 1, 1.0e-2, 1.0e-3, 1.1e-2 on 1177.4
    (8.8e-6 of it); val total at epoch 1, 3.5e-6, 1.6e-7, 3.3e-6 on 0.70."""
    jt, _ = runs["jax"]
    logs = {"jax": _logs(jt.workdir), "port": _logs(runs["port"].workdir),
            "f64": _logs(runs["f64"].workdir)}
    for name, columns in (("split1.log", TRAIN_COLUMNS), ("split1_val.log", VAL_COLUMNS)):
        assert all(len(logs[k][name]) == 2 and list(logs[k][name][0]) == columns for k in logs)
        for epoch in range(2):
            row = {k: logs[k][name][epoch] for k in logs}
            for col in columns:
                if col in ("epoch", "total_step", "lr"):
                    assert row["port"][col] == row["jax"][col] == row["f64"][col], (name, col)
                    continue
                p, j, f = (float(row[k][col]) for k in ("port", "jax", "f64"))
                scale = max(abs(j), 1.0)
                print(f"{name} epoch {epoch} {col}: port {p:.6g} JAX {j:.6g} f64 {f:.6g} "
                      f"|p-j| {abs(p - j):.2e} |p-f64| {abs(p - f):.2e} |j-f64| {abs(j - f):.2e}")
                assert np.isfinite(p) and abs(p - j) <= LOGS * scale, (name, epoch, col, p, j)
                assert max(abs(p - f), abs(j - f)) <= LOGS * scale, (name, epoch, col, p, j, f)
    assert [r["total_step"] for r in logs["port"]["split1.log"]] == ["2", "4"]
    assert runs["port"].best["step"] == jt.ckpt.best()["step"] == runs["f64"].best["step"]


def zero_gradient_tensors(moments):
    """The trainable tensors whose first moment is zero up to rounding (at
    most 1e-6 of the largest): gradients that a softmax (the key-side
    LayerNorm biases) or a batch-statistics BatchNorm (the head conv's
    bias) cancels, and the audio branch's, which is zero by construction at
    64x96 (tests/test_train.py:138-141)."""
    top = max(float(v.abs().max()) for v in moments["mu"].values())
    return {n for n, v in moments["mu"].items() if float(v.abs().max()) <= 1e-6 * top}


def test_trainer_parameters_match_jax(runs):
    """Every floating state_dict entry after each epoch, port f32 against
    JAX f32 directly: the relative L2 of their difference over JAX's own
    update (its move from the initial weights; 4 Adam steps move a weight
    by ~4 lr, far less than the weight itself) within PARAMS. Measured:
    4.9e-3 at most (one element of 768 in blocks.9.norm1.weight, whose
    gradient sign rounding decides, so that Adam moves it ~2 lr the other
    way), median 1.0e-4. Where the gradient is zero up to rounding
    (`zero_gradient_tensors`, from JAX's moments; the moment test holds the
    port's there too), Adam moves each element by up to lr a step on
    rounding noise: element by element within the sum of the steps' lr.
    Each f32 side is also held to the port's f64 run within F32_RUN of its
    update, as the check on rounding (measured 3.4e-3 at most)."""
    jt, jax_params = runs["jax"]
    init = runs["init"]
    zero = zero_gradient_tensors(jax_moments(jt.state, runs["cfg"].model.visual.num_layers))
    assert {n for n in zero if n.endswith("norm_k.bias") or ".mt_proj.0." in n} == {
        f"visual_net.blocks.{i}.attn.norm_k.bias" for i in range(10)} | {
        "decoder_net.invpt_decoder.mt_proj.0.bias"}, sorted(zero)
    lr = [float(jt.lr_schedule(k)) for k in range(4)]
    for epoch in range(2):
        budget = sum(lr[: 2 * (epoch + 1)])
        ref, got, f64 = jax_params[epoch], runs["port"].params[epoch], runs["f64"].params[epoch]
        assert set(ref) == set(got) == set(f64), set(ref) ^ set(got)
        rel = []
        for name, j in ref.items():
            if not j.is_floating_point():
                continue
            j, p, f = j.double(), got[name].double(), f64[name].double()
            if name in zero:
                for side in (p, j):
                    assert float((side - f).abs().max()) <= budget, (epoch, name)
                continue
            u = float((j - init[name].double()).norm())
            if u == 0:  # the frozen VGGish
                assert torch.equal(p, j), (epoch, name)
                continue
            rel.append((float((p - j).norm()) / u, name))
            gp, gj = float((p - f).norm()) / u, float((j - f).norm()) / u
            assert rel[-1][0] <= PARAMS and max(gp, gj) <= F32_RUN, (epoch, name, rel[-1], gp, gj)
        assert len(rel) > 300
        print(f"epoch {epoch}: {len(rel)} tensors, relative L2 of port - JAX over JAX's update: "
              f"median {np.median([r for r, _ in rel]):.2e}, largest {max(rel)}")


def test_trainer_adam_moments_match_jax(runs):
    """Adam's count and moments after the 4 steps, port f32 against JAX f32
    directly. The first moment is a decaying sum of the clipped gradients
    and the second of their squares: smooth in the gradients, where the
    parameters are not. So they pin down every step's gradient (batch,
    draws, loss, the BatchNorm statistics carried between steps, the
    weights each step starts from), the clip, b1, b2 and the count, held at
    MOMENTS relative L2 per tensor. Measured: first moments median 1.6e-4,
    largest 2.6e-4; second 1.2e-4, 2.8e-4 (against the port's f64 run: port
    6.0e-5 / 8.0e-5 at most, JAX 2.9e-4 / 2.3e-4). Where JAX's first moment
    is zero up to rounding (`zero_gradient_tensors`) the port's moments are
    held to that absolute bound."""
    jt, _ = runs["jax"]
    t = runs["port"].trainer
    jax_m = jax_moments(jt.state, runs["cfg"].model.visual.num_layers)
    port_m = t.optimizer.state_dict(t._trainable_names())
    zero = zero_gradient_tensors(jax_m)
    assert port_m["count"] == jax_m["count"] == 4
    for key in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in jax_m[key].values())
        rel = []
        for name, p in port_m[key].items():
            j, p = jax_m[key][name].double(), p.double()
            if name in zero:
                assert float(p.abs().max()) <= 1e-6 * top, (key, name)
                continue
            rel.append((float((p - j).norm() / j.norm()), name))
        print(f"{key}: {len(rel)} tensors, relative L2 port - JAX median "
              f"{np.median([r for r, _ in rel]):.2e}, largest {max(rel)}")
        assert len(rel) > 300 and max(rel)[0] <= MOMENTS, (key, max(rel))


@pytest.fixture(scope="module")
def jax_f64(runs, packed, tmp_path_factory):
    """JAX's trainer in f64 (`jax.enable_x64`, compute_dtype "float64"; the
    model's explicit f32 islands stay f32) on the same tree, weights, keys
    and branches as the other runs. Under x64, `randint` and `normal`
    without a dtype draw other bits, so this run draws them as the f32 run
    does (int32, float32): it takes the draws the port's f64 run took."""
    root, config = packed
    cfg = runs["cfg"]
    cfg64 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float64"))
    variables = jax.tree.map(
        lambda x: x.astype(np.float64) if x.dtype == np.float32 else x, runs["variables"])
    randint, normal = jax.random.randint, jax.random.normal
    with jax.enable_x64(True):
        jax.random.randint = lambda key, shape, minval, maxval, dtype=jnp.int32: randint(
            key, shape, minval, maxval, dtype)
        jax.random.normal = lambda key, shape=(), dtype=jnp.float32: normal(key, shape, dtype)
        try:
            jt, params = run_jax_trainer(cfg64, str(tmp_path_factory.mktemp("jax64") / "split1"),
                                         root, config, variables, runs["branches"], runs["keys"])
            moments = jax_moments(jt.state, cfg.model.visual.num_layers)
        finally:
            jax.random.randint, jax.random.normal = randint, normal
    return jt, params, moments


@pytest.mark.slow
def test_trainer_f64_matches_jax_trainer_f64(runs, jax_f64):
    """The port's f64 run against JAX's trainer in f64, both taking the
    same branches: a reference for the port's trainer that shares none of
    its code. Every log value within F64_LOGS of max(|JAX's|, 1) (the lr
    column, which JAX computes in f64 here, within 1e-7 relative); every
    floating state_dict entry after each epoch within F64_PARAMS of JAX's
    update (relative L2; the zero-gradient tensors element by element
    within the sum of the steps' lr); Adam's moments within F64_MOMENTS
    relative L2. Measured: logs 7.0e-7; parameters median 1.6e-5, largest
    4.4e-4 (blocks.0.attn.pool_k.weight); first moments median 3.5e-5,
    largest 5.0e-5; second 2.6e-5, 1.2e-4. JAX's f64 model keeps explicit
    f32 islands (the target, the timestep embedding, the logits head, MViT's
    pooling), hence ~1e-5 and not f64 rounding. JAX's f64 trainer takes
    ~17 minutes (each step ~3 minutes: XLA's f64 convolutions on a CPU)
    and ~14 GB, hence `slow`."""
    jt, jax_params, jax_m = jax_f64
    ref = runs["f64"]
    logs = {"jax": _logs(jt.workdir), "f64": _logs(ref.workdir)}
    worst = {"logs": 0.0, "params": [], "mu": [], "nu": []}
    for name, columns in (("split1.log", TRAIN_COLUMNS), ("split1_val.log", VAL_COLUMNS)):
        for epoch in range(2):
            row = {k: logs[k][name][epoch] for k in logs}
            for col in columns:
                p, j = float(row["f64"][col]), float(row["jax"][col])
                if col in ("epoch", "total_step"):
                    assert p == j, (name, col)
                elif col == "lr":
                    assert abs(p - j) <= 1e-7 * j, (name, epoch, p, j)
                else:
                    d = abs(p - j) / max(abs(j), 1.0)
                    worst["logs"] = max(worst["logs"], d)
                    assert d <= F64_LOGS, (name, epoch, col, p, j)
    assert ref.best["step"] == jt.ckpt.best()["step"]
    zero = zero_gradient_tensors(jax_m)
    lr = [float(jt.lr_schedule(k)) for k in range(4)]
    for epoch in range(2):
        budget = sum(lr[: 2 * (epoch + 1)])
        for name, j in jax_params[epoch].items():
            if not j.is_floating_point():
                continue
            p = ref.params[epoch][name].double()
            if name in zero:
                assert float((p - j).abs().max()) <= budget, (epoch, name)
                continue
            u = float((j - runs["init"][name].double()).norm())
            if u == 0:  # the frozen VGGish
                assert torch.equal(p, j), (epoch, name)
                continue
            worst["params"].append((float((p - j).norm()) / u, name))
            assert worst["params"][-1][0] <= F64_PARAMS, (epoch, worst["params"][-1])
    port_m = ref.trainer.optimizer.state_dict(ref.trainer._trainable_names())
    assert port_m["count"] == jax_m["count"] == 4
    for key in ("mu", "nu"):
        for name, p in port_m[key].items():
            if name not in zero:
                j = jax_m[key][name]
                worst[key].append((float((p - j).norm() / j.norm()), name))
                assert worst[key][-1][0] <= F64_MOMENTS, (key, worst[key][-1])
    print(f"port f64 - JAX f64: logs {worst['logs']:.2e}; " + "; ".join(
        f"{k} median {np.median([r for r, _ in worst[k]]):.2e} largest {max(worst[k])}"
        for k in ("params", "mu", "nu")))


# -- the port alone -------------------------------------------------------------


def visual_cfg(**training):
    cfg = tiny_cfg()
    return pc.from_fields(dataclasses.replace(
        cfg, training=dataclasses.replace(cfg.training, **training)))


class Interrupt(Exception):
    pass


class StopAt:
    """A loader that raises when an epoch >= `epoch` starts."""

    def __init__(self, loader, epoch):
        self.loader, self.stop = loader, epoch

    def set_epoch(self, epoch):
        if epoch >= self.stop:
            raise Interrupt
        self.loader.set_epoch(epoch)

    def __iter__(self):
        return iter(self.loader)

    def __len__(self):
        return len(self.loader)


def _sd_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """One run of 2 epochs x 1 step (dropout and DropPath on, EMA on; its
    checkpoints kept in memory), and the same run interrupted before its
    second epoch and resumed by a new trainer on its workdir (its
    checkpoints written, ~0.75 GB each)."""
    cfg = visual_cfg(ema=True, ema_rate=0.5)
    ds = SyntheticAVDataset(n=2, img_size=HW, frames=16)
    loader = lambda: Loader(ds, B, shuffle=True, num_workers=0)  # noqa: E731
    val = Loader(ds, B, shuffle=False, num_workers=0)
    work = tmp_path_factory.mktemp("resume")
    with one_torch_thread():
        whole = Trainer(cfg, str(work / "whole"), 1, n_epochs=2, device="cpu")
        whole.init_state()
        saved = keep_in_memory(whole)
        whole.fit(loader(), val)
        part = Trainer(cfg, str(work / "part"), 1, n_epochs=2, device="cpu")
        part.init_state()
        with pytest.raises(Interrupt):
            part.fit(StopAt(loader(), 1), val)
        again = Trainer(cfg, str(work / "part"), 1, n_epochs=2, device="cpu")
        again.init_state(seed=5)
        again.resume()
        assert (again.epoch, again.global_step) == (1, 1)
        again.fit(loader(), val)
    yield whole, again, saved
    shutil.rmtree(str(work))


def test_resume_matches_an_uninterrupted_run_bitwise(resumed):
    whole, again, saved = resumed
    for name in ("train.log", "train_val.log"):
        with open(os.path.join(whole.workdir, name)) as f1, \
                open(os.path.join(again.workdir, name)) as f2:
            assert f1.read() == f2.read(), name
    _sd_equal(whole.model.state_dict(), again.model.state_dict())
    names = whole._trainable_names()
    a, b = whole.optimizer.state_dict(names), again.optimizer.state_dict(names)
    assert a["count"] == b["count"] == 2
    for key in ("mu", "nu", "ema"):
        _sd_equal(a[key], b[key])
    for step in (0, 1):
        x, y = saved[step], again.ckpt.restore(step)
        assert sorted(y) == ["epoch", "optim_dict", "state_dict", "step"]
        assert (x["epoch"], x["step"]) == (y["epoch"], y["step"]) == (step, step + 1)
        _sd_equal(x["state_dict"], y["state_dict"])
    assert whole.ckpt.best() == again.ckpt.best()


def test_restore_best_and_evaluate_with_ema(resumed, tmp_path):
    whole, again, _ = resumed
    best = again.ckpt.best()
    scores = [float(r["total"]) for r in read_log(os.path.join(again.workdir, "train_val.log"))]
    assert best["step"] == int(np.argmax(scores)) and best["score"] == max(scores)
    t = Trainer(again.cfg, again.workdir, 1, n_epochs=2, device="cpu")
    t.init_state(seed=9)
    t.restore_best()
    _sd_equal(t.model.state_dict(), again.ckpt.restore(best["step"])["state_dict"])
    empty = Trainer(whole.cfg, str(tmp_path / "none"), 2, device="cpu")
    empty.init_state()
    with pytest.raises(FileNotFoundError):
        empty.restore_best()

    ds = SyntheticAVDataset(n=3, img_size=HW, frames=16)
    val = Loader(ds, B, shuffle=False, drop_last=False, pad_last=True, num_workers=0)
    before = {k: v.clone() for k, v in whole.model.state_dict().items()}
    with one_torch_thread():
        plain = whole.evaluate(val)
        ema = whole.evaluate(val, use_ema=True, save_images_dir=str(tmp_path / "maps"))
    _sd_equal(before, whole.model.state_dict())  # the EMA was swapped back out
    assert plain.keys() == ema.keys() == {"total", "kl", "cc", "sim", "nss"}
    assert plain["total"] != ema["total"]
    dumped = sorted(os.listdir(tmp_path / "maps"))
    assert dumped == ["0", "1", "2"]  # the padded copy of item 2 rewrites its file
    assert os.listdir(tmp_path / "maps" / "2") == ["0002.png"]


def test_warm_start_and_partial_load_counts_match_jax(resumed, tmp_path):
    whole = resumed[0]
    av = pc.from_fields(parity_cfg(audio=True))
    t = Trainer(av, str(tmp_path / "av"), 2, device="cpu")
    t.init_state()
    initial = {k: v.clone() for k, v in t.model.state_dict().items()}
    source = whole.model.state_dict()
    t.warm_start(source)
    sd = t.model.state_dict()
    params = dict(t.model.named_parameters())
    for k, v in source.items():
        # parameters from the source; buffers (BatchNorm statistics, which
        # the source's two training steps moved) keep their initial values
        assert torch.equal(sd[k], v if k in params else initial[k]), k
    assert any(not torch.equal(v, initial[k]) for k, v in source.items() if k not in params)
    assert any(k.startswith("audio_net.") for k in sd)

    rng = np.random.RandomState(3)
    target = {"a": {"w": rng.randn(3, 4), "b": rng.randn(4)}, "c": {"w": rng.randn(2)},
              "d": rng.randn(5)}
    source = {"a": {"w": rng.randn(3, 4), "b": rng.randn(5)}, "d": rng.randn(5),
              "e": rng.randn(1)}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else
                       {prefix + k: torch.from_numpy(v)})
        return out

    _, j_loaded, j_skipped = jckpt.partial_load(target, source)
    merged, loaded, skipped = pckpt.partial_load(flat(target), flat(source))
    assert (loaded, skipped) == (j_loaded, j_skipped) == (2, 2)
    assert torch.equal(merged["a.w"], flat(source)["a.w"])
    assert torch.equal(merged["a.b"], flat(target)["a.b"])


def test_warm_start_loads_parameters_only_as_jax(tmp_path):
    """F8: both packages warm-start from a source whose BatchNorm running
    statistics are far from the initial ones (`random_variables`: means
    0.05 N(0, 1), variances 0.5 + 0.5 |N(0, 1)|). Every parameter ends
    equal to the source's, in both; every statistic (the decoder's 7
    BatchNorms: mean, variance and torch's counter) keeps each package's
    initial value."""
    from test_torch_models import random_variables

    cfg = parity_cfg(audio=True)
    layers = cfg.model.visual.num_layers
    h, w = HW
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0), {
        "rgb": jnp.zeros((1, 16, h, w, 3)), "input": jnp.zeros((1, h, w, 1)),
        "audio": jnp.zeros((1, 9, h // 2, w // 2, 1))}, jnp.zeros((1,)))
    init, src = flax_like_variables(shapes, seed=51), random_variables(shapes, seed=52)
    source = bridge.state_dict_from_flax(src, layers)

    jt = JTrainer(cfg, str(tmp_path / "jax"), steps_per_epoch=2, n_epochs=2, use_mesh=False)
    jt.state = create_train_state(jt.model, init, jt.tx)
    jt.warm_start(src["params"])
    jax_sd = bridge.state_dict_from_flax(jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}), layers)
    jax_init = bridge.state_dict_from_flax(init, layers)

    t = Trainer(pc.from_fields(cfg), str(tmp_path / "port"), 2, device="cpu")
    t.init_state()
    port_init = {k: v.clone() for k, v in t.model.state_dict().items()}
    t.warm_start(source)
    port_sd = t.model.state_dict()
    params = dict(t.model.named_parameters())

    assert set(port_sd) == set(jax_sd) == set(source)
    stats = sorted(k for k in port_sd if k not in params)
    assert len(stats) == 21 and all(k.startswith("decoder_net.") for k in stats), stats
    for k in port_sd:
        if k in params:
            assert torch.equal(port_sd[k], source[k]) and torch.equal(jax_sd[k], source[k]), k
        else:
            assert torch.equal(port_sd[k], port_init[k]), k
            assert torch.equal(jax_sd[k], jax_init[k]), k
            # the bridge's counters are (1,): load_state_dict takes them as ()
            assert torch.equal(port_sd[k], jax_sd[k].reshape(port_sd[k].shape)), k
            if not k.endswith("num_batches_tracked"):
                assert not torch.equal(source[k], port_init[k]), k


def test_train_av_splits_ran_the_packed_protocol(runs):
    t = runs["port"].trainer
    assert t.cfg.model.uint8_norm == "stavis"  # switched for the packed uint8 frames
    assert (t.epoch, t.global_step, runs["port"].steps) == (2, 4, [0, 1])
    assert t.workdir.endswith(os.path.join("port", "split1"))
    assert t.timer.step_time.count == t.timer.data_time.count == 2
    for name in ("split1.log", "split1_val.log"):
        rows = read_log(os.path.join(t.workdir, name))
        assert len(rows) == 2 and all(np.isfinite(float(r[k])) for r in rows for k in r)
    ckpt = runs["port"].last
    assert sorted(ckpt) == ["epoch", "optim_dict", "state_dict", "step"]
    assert (ckpt["epoch"], ckpt["step"], ckpt["optim_dict"]["count"]) == (1, 4, 4)
    assert ckpt["optim_dict"]["ema"] is None
    names = t._trainable_names()
    assert list(ckpt["optim_dict"]["mu"]) == names and not any(
        n.startswith("audio_net.") for n in names)
    assert set(ckpt["state_dict"]) == set(t.model.state_dict())


def test_checkpoint_manager(tmp_path):
    m = pckpt.CheckpointManager(str(tmp_path / "w"), max_to_keep=2)
    assert m.latest_step() is None and m.restore() is None and m.restore_best() is None
    for step, score in ((0, 1.0), (1, 3.0), (2, 2.0), (3, 0.5)):
        m.save(step, {"state_dict": {"x": torch.full((2,), float(step))}, "epoch": step,
                      "step": step, "optim_dict": {}})
        m.update_best(step, score)
    # the latest two, and the best (step 1) kept
    assert m.all_steps() == [1, 2, 3] and m.latest_step() == 3
    assert m.best() == {"step": 1, "score": 3.0}
    assert float(m.restore_best()["state_dict"]["x"][0]) == 1.0
    assert not m.update_best(4, 3.0) and m.update_best(4, 3.5)
    assert not [n for n in os.listdir(m.directory) if n.endswith(".tmp")]


def test_logging_matches_jax(tmp_path):
    for mod in (plog, jlog):
        meters = mod.AverageMeterDict()
        meters.update({"a": 1.0, "b": 2.0}, 3)
        meters.update({"a": 4.0}, 1)
        assert meters.averages() == {"a": 1.75, "b": 2.0}
        logger = mod.TSVLogger(str(tmp_path / mod.__name__ / "x.log"), ["epoch", "loss", "lr"])
        logger.log({"epoch": 0, "loss": 0.123456789, "lr": np.float32(1e-4).item()})
        logger.log({"epoch": 1, "lr": 1e-5})
        logger.close()
        assert mod.StepTimer().data_time.count == 0
    texts = [(tmp_path / m.__name__ / "x.log").read_text() for m in (plog, jlog)]
    assert texts[0] == texts[1]
    x = np.random.RandomState(0).randn(20, 30, 1)
    for arr in (x, np.zeros((4, 4)), x * 1e6):
        np.testing.assert_array_equal(plog.normalize_to_uint8(arr), jlog.normalize_to_uint8(arr))
    plog.save_saliency_image(str(tmp_path / "p" / "m.png"), x)
    jlog.save_saliency_image(str(tmp_path / "j" / "m.png"), x)
    written = [(tmp_path / side / "m.png").read_bytes() for side in ("p", "j")]
    assert written[0] == written[1]
    noop = plog.maybe_wandb(False)
    noop.log({"a": 1})
    noop.finish()


def test_debug_helpers():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    pdebug.check_finite(model, "model")
    norms = pdebug.tree_norms(model)
    want = float(torch.cat([p.detach().flatten() for p in model[0].parameters()]).norm())
    assert set(norms) == {"0", "1"} and abs(norms["0"] - want) < 1e-6
    tensors = {"ok": torch.ones(2), "sub": {"bad": torch.tensor([1.0, float("nan"), float("inf")])}}
    with pytest.raises(FloatingPointError, match="sub.bad: nan=1 inf=1"):
        pdebug.check_finite(tensors)
    with torch.no_grad():
        model[1].running_var[0] = float("inf")
    with pytest.raises(FloatingPointError, match="running_var"):
        pdebug.check_finite(model)
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError):
        with pdebug.nan_guard():
            torch.sqrt(x).sum().backward()
    with pdebug.nan_guard(False):
        torch.sqrt(x).sum().backward()


def test_param_counts_match_jax():
    from diff_sal_tpu.models.diff_model import param_counts as j_counts
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, param_counts

    cfg = parity_cfg(audio=True).model
    h, w = HW
    shapes = jax.eval_shape(
        JModel(cfg).init,
        jax.random.PRNGKey(0),
        {"rgb": jnp.zeros((1, 16, h, w, 3)), "input": jnp.zeros((1, h, w, 1)),
         "audio": jnp.zeros((1, 9, h // 2, w // 2, 1))}, jnp.zeros((1,)))
    ref = {k: float(v) for k, v in j_counts(shapes).items()}
    model = VideoSaliencyModel(pc.from_fields(cfg))
    got = param_counts(model)
    # the CvT query projections are the reference's Conv3d with kt = 3 (only
    # the centre slice set, bridge.py), where JAX keeps the 2-D kernel
    extra = sum(p.numel() * 2 // 3 for n, p in model.named_parameters()
                if n.endswith("conv_proj_q.conv.weight"))
    ref["decoder_net"] += extra / 1e6
    assert extra == 18 * sum(cfg.decoder.up_channel)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) < 1e-9, (k, got[k], ref[k])
