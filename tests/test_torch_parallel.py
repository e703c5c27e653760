"""Data parallelism of the port (`parallel/`, the BatchNorm statistics over
the global batch, the step, the trainer and the CLI across ranks) on the
CPU: two gloo ranks as subprocesses.

One module fixture launches everything: two ranks of this file run as a
script (`python tests/test_torch_parallel.py <spec> <rank>`, a process
group over tcp://127.0.0.1 on a free port) and a third process runs the
single-process references (`... <spec> single`), while the test process
computes JAX's side. Each process runs on one torch thread and writes an
.npz; the launch has a subprocess timeout and every process group a
timeout of its own, so a hang fails the fixture and cannot eat the suite's
time. The workers import torch, numpy and the port only; JAX is imported
in the tests.

The model is JAX's `tiny_cfg` with the audio branch (MViT tiny, VGGish,
AudioAttnNet, SalUNet at 64x96, the smallest size the default decoder's
CvT key pools take: at 32x48 its last stage's 16x16 pool exceeds the 2x3
grid), decoder dropout and DropPath 0 (the ranks' masks are their own, so
no mask can be shared with one process). The global training batch is 2
clips (one per rank); evaluation 4, the last a padded duplicate. The
cases:
1. the port's `BatchNorm` on 2 ranks against flax's on the concatenated
   batch: output, running statistics, input and parameter gradients
   (1e-5, f32);
2. one 2-rank step in f64 against the port's one-process f64 step on the
   same global batch and draws (the shared generator on both sides): loss
   1e-12 relative, parameters, Adam's moments and BatchNorm statistics
   1e-9 relative L2 per tensor (tensors whose gradient is zero up to
   rounding, 1e-6 of the largest, only within 1e-12 absolute); the two
   ranks bitwise equal;
3. one 2-rank f32 step with JAX's draws against JAX's step on a 2-device
   mesh (tests/test_parallel.py's layout and bounds: loss rtol 2e-4,
   parameters 1e-3 absolute), and the BatchNorm statistics within
   1e-5 max|stat| + 1e-6 of JAX's; `slow`: JAX's two mesh compiles take
   80-130 s, which would more than double the file's time;
4. the 2-rank eval step (DDIM NFE 1, padded tail) against JAX's mesh eval
   step (test_dp_eval_step_on_mesh's bounds: total rtol 2e-4, maps atol
   1e-4; `slow`, as 3), and DDIM NFE 1 and DPM-Solver++ 2M NFE 2 on 2
   ranks against one process (maps 1e-5, scores 1e-5 relative);
5. `train_av_splits` on 2 ranks over a packed tree of 5 training windows
   (not a multiple of W b = 2): the same number of steps on each rank, one
   set of logs and checkpoints (rank 1 writes none), the logs and the best
   epoch as the one-process run's (test_torch_trainer.py's f32 bound,
   1e-4 of max(|value|, 1)), the ranks' parameters bitwise equal;
6. the units: `make_mesh_for_batch` raises on an indivisible batch,
   `shard_batch` takes rows r::W, `multihost` in one process as JAX's
   tests/test_utils.py:40-45, `--no_mesh` under WORLD_SIZE=2 raises, the
   loader's even-shard cut.
"""

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HW = (64, 96)
W = 2
B_TRAIN = 2   # global: one clip per rank
B_EVAL = 4    # global, the last row a padded duplicate
LR = 1e-4
# the train tree: 5 windows (80 + 80 + 20 frames at 20 fps), 2 test windows
FOLDS = {"train": (("v1", 80), ("v2", 80), ("v3", 20)), "test": (("e1", 80),)}
LAUNCH_TIMEOUT_S = 420   # the whole launch (ranks and single-process references)
GROUP_TIMEOUT_S = 300    # each collective
LOGS = 1e-4              # tests/test_torch_trainer.py's f32 log bound


def model_cfg():
    """The port's config of the JAX tiny AV model with dropout and DropPath
    0 (the same fields as `jax_cfg`)."""
    from diff_sal_tpu_torch import config as pc

    return pc.ExperimentConfig(
        model=pc.ModelConfig(
            visual=pc.MViTConfig.tiny(spatial_size=HW), audio=pc.VGGishConfig(),
            spatiotemp=pc.AudioAttnConfig(),
            decoder=pc.SalUNetConfig(img_size=HW, dropout=0.0, drop_path_rate=(0.0,) * 4)),
        optim=pc.OptimConfig(lr=LR),
        training=pc.TrainingConfig(batch_size=B_TRAIN, log_freq=1, n_epochs_for_av_data=2))


def dpm_cfg(cfg):
    from diff_sal_tpu_torch import config as pc

    return dataclasses.replace(cfg, sampling=pc.SamplingConfig(
        sample_type="dpmsolver++", timesteps=2, dpm_solver_order=2,
        dpm_solver_method="multistep", skip_type="logSNR"))


# -- the worker: a rank, or the single-process references --------------------


def _build(cfg, weights, double=False):
    from diff_sal_tpu_torch.models.diff_model import build_model

    model = build_model(cfg.model, seed=0, device="cpu", train=True)
    model.load_state_dict(weights)
    return model.double() if double else model


def _state(model, opt):
    """Parameters and buffers but the frozen VGGish's, Adam's moments, as
    numpy."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    out = {f"sd/{k}": v.detach().numpy().copy() for k, v in model.state_dict().items()
           if not k.startswith("audio_net.")}
    sd = opt.state_dict(names)
    out.update({f"mu/{k}": v.numpy().copy() for k, v in sd["mu"].items()})
    out.update({f"nu/{k}": v.numpy().copy() for k, v in sd["nu"].items()})
    return out


def _keep(prefix, state, full: bool, digests: bool = True):
    """`state` under `prefix`: the arrays where `full`, and each array's
    digest where `digests` (rank 1 sends only those, for the bitwise
    check)."""
    out = {f"{prefix}/hash/{k}": np.asarray(hashlib.sha256(
        np.ascontiguousarray(v).tobytes()).hexdigest()) for k, v in state.items() if digests}
    if full:
        out.update({f"{prefix}/{k}": v for k, v in state.items()})
    return out


def _torch_batch(arrays, keys, rows=slice(None), dtype=torch.float32):
    return {k: torch.from_numpy(arrays[k][rows]).to(dtype) for k in keys}


def case_batchnorm(inp, group, r):
    """Case 1: the port's BatchNorm over the ranks' rows."""
    from diff_sal_tpu_torch.models.layers import BatchNorm
    from diff_sal_tpu_torch.parallel import mesh

    x, gy = inp["bn_x"], inp["bn_gy"]
    bn = BatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_bias"]))
    bn.stats_group = group
    xr = torch.from_numpy(x[r::W]).requires_grad_(True)
    y = bn(xr, train=True)
    (y * torch.from_numpy(gy[r::W])).sum().backward()
    # the parameters' gradient of the global sum: each rank's part, summed
    dp = torch.cat([bn.weight.grad, bn.bias.grad])
    torch.distributed.all_reduce(dp, group=group)
    C = x.shape[-1]
    return {"bn/y": y.detach().numpy(), "bn/dx": xr.grad.numpy(),
            "bn/dscale": dp[:C].numpy(), "bn/dbias": dp[C:].numpy(),
            "bn/mean": bn.running_mean.numpy().copy(), "bn/var": bn.running_var.numpy().copy(),
            "bn/n_norms": np.asarray(mesh.world_size(group))}


def step_f64(cfg, weights, inp, group=None, r=0):
    """Case 2: one f64 step with the shared generator's draws, on the
    global batch (group None) or on rank r's rows."""
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    model = _build(cfg, weights, double=True)
    opt = make_optimizer(model, cfg.optim, steps_per_epoch=4, n_epochs=2)
    step = make_train_step(model, make_schedule(), cfg, group)
    rows = slice(None) if group is None else slice(r, None, W)
    batch = _torch_batch(inp, ("rgb", "salmap", "audio"), rows, torch.float64)
    kw = {} if group is None else {"mask_generator": torch.Generator().manual_seed(100 + r)}
    m = step(opt, batch, torch.Generator().manual_seed(5), **kw)
    out = _keep("f64", _state(model, opt), r == 0, group is not None)
    out.update({f"f64m/{k}": np.asarray(float(v)) for k, v in m.items()})
    return out


def step_f32_jax_draws(cfg, weights, inp, group, r):
    """Case 3: one f32 step on rank r's rows with JAX's global draws."""
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    model = _build(cfg, weights)
    opt = make_optimizer(model, cfg.optim, steps_per_epoch=4, n_epochs=2)
    step = make_train_step(model, make_schedule(), cfg, group)
    batch = _torch_batch(inp, ("rgb", "salmap", "audio"), slice(r, None, W))
    draws = {k: torch.from_numpy(inp[f"draw_{k}"]) for k in ("deq", "t", "noise")}
    m = step(opt, batch, None, draws=draws, mask_generator=torch.Generator().manual_seed(r))
    out = _keep("f32", {k: v for k, v in _state(model, opt).items() if k.startswith("sd/")},
                r == 0)
    out.update({f"f32m/{k}": np.asarray(float(v)) for k, v in m.items()})
    return out


def eval_runs(cfg, weights, inp, group=None, r=0):
    """Case 4: DDIM NFE 1 with JAX's x_T and DPM++ NFE 2 on the padded
    eval batch: this rank's (or the whole batch's) scores, their count of
    real rows and maps, and with a group the scores reduced over the
    ranks."""
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.parallel import mesh
    from diff_sal_tpu_torch.train.train_step import make_eval_step

    model = _build(cfg, weights).eval()
    rows = slice(None) if group is None else slice(r, None, W)
    batch = {k: torch.from_numpy(inp[f"ev_{k}"][rows]) for k in ("rgb", "salmap", "audio",
                                                                  "valid")}
    out = {}
    for name, c in (("ddim", cfg), ("dpm", dpm_cfg(cfg))):
        step = make_eval_step(model, make_schedule(), c, group)
        with torch.no_grad():
            scores, pred = step(batch, None, noise=torch.from_numpy(inp["ev_noise"]))
        n = float(batch["valid"].sum())
        out[f"{name}/pred"] = pred.numpy()
        out.update({f"{name}/score/{k}": np.asarray(float(v)) for k, v in scores.items()})
        if group is not None:
            glob = mesh.reduce_weighted({k: float(v) * n for k, v in scores.items()}, n,
                                        group, "cpu")
            out.update({f"{name}/global/{k}": np.asarray(v) for k, v in glob.items()})
    return out


def fit_run(cfg, weights, spec, group, r):
    """Case 5: `train_av_splits` over the packed tree, counting each rank's
    steps, log files, checkpoint saves and best-checkpoint updates."""
    from diff_sal_tpu_torch.train import checkpoint, trainer
    from diff_sal_tpu_torch.utils import logging as plog

    counts = {"steps": 0, "loggers": 0, "saves": 0, "best": 0, "steps_per_epoch": 0}
    init_state, tsv_init = trainer.Trainer.init_state, plog.TSVLogger.__init__
    save, update_best = checkpoint.CheckpointManager.save, checkpoint.CheckpointManager.update_best

    def counting(key, fn):
        def call(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return call

    def init_counting(self, *a, **kw):
        init_state(self, *a, **kw)
        counts["steps_per_epoch"] = self.steps_per_epoch
        self.train_step = counting("steps", self.train_step)

    trainer.Trainer.init_state = init_counting
    plog.TSVLogger.__init__ = counting("loggers", tsv_init)
    checkpoint.CheckpointManager.save = counting("saves", save)
    checkpoint.CheckpointManager.update_best = counting("best", update_best)
    try:
        with open(spec["data_config"]) as f:
            data_config = json.load(f)
        workdir = spec["fit_dp"] if group is not None else spec["fit_single"]
        t = trainer.train_av_splits(cfg, data_config, workdir, visual_best_params=weights,
                                    splits=("split1",), packed_root=spec["packed"],
                                    loader_kwargs={"num_workers": 0}, device="cpu",
                                    group=group)["split1"]
    finally:
        trainer.Trainer.init_state, plog.TSVLogger.__init__ = init_state, tsv_init
        checkpoint.CheckpointManager.save = save
        checkpoint.CheckpointManager.update_best = update_best
    out = {f"fit/count/{k}": np.asarray(v) for k, v in counts.items()}
    out.update(_keep("fit", {k: v.detach().numpy() for k, v in t.model.state_dict().items()
                             if not k.startswith("audio_net.")}, False))
    return out


def units(group, r):
    """Case 6, the parts that need the process group."""
    from diff_sal_tpu_torch.parallel import mesh, multihost

    out = {"unit/rows": np.asarray(mesh.shard_batch({"x": np.arange(7)}, group)["x"]),
           "unit/info": np.asarray([multihost.process_info()[k] for k in (
               "process_index", "process_count", "local_devices", "global_devices")])}
    try:
        mesh.make_mesh_for_batch(3)
        out["unit/indivisible_raised"] = np.asarray(False)
    except ValueError:
        out["unit/indivisible_raised"] = np.asarray(True)
    out["unit/divisible_group"] = np.asarray(mesh.make_mesh_for_batch(4) is group)
    return out


def worker(spec_path: str, role: str) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    inp = dict(np.load(spec["inputs"]))
    weights = torch.load(spec["weights"], weights_only=True)
    cfg = model_cfg()
    out = {}
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out.update(fn(*args))
        out[f"seconds/{name}"] = np.asarray(time.perf_counter() - t)

    if role == "single":
        timed("f64", step_f64, cfg, weights, inp)
        timed("eval", eval_runs, cfg, weights, inp)
        timed("fit", fit_run, cfg, weights, spec, None, 0)
    else:
        from diff_sal_tpu_torch.parallel import mesh, multihost

        r = int(role)
        multihost.initialize(init_method=f"tcp://127.0.0.1:{spec['port']}", world_size=W,
                             rank=r, device="cpu", timeout_s=spec["group_timeout"])
        try:
            group = mesh.make_mesh()
            timed("units", units, group, r)
            timed("batchnorm", case_batchnorm, inp, group, r)
            timed("f64", step_f64, cfg, weights, inp, group, r)
            timed("f32", step_f32_jax_draws, cfg, weights, inp, group, r)
            timed("eval", eval_runs, cfg, weights, inp, group, r)
            timed("fit", fit_run, cfg, weights, spec, group, r)
        finally:
            multihost.shutdown()
    out["seconds/all"] = np.asarray(time.perf_counter() - t0)
    np.savez(os.path.join(spec["out"], f"{role}.npz"), **out)
    return 0


# -- the launch ----------------------------------------------------------------


def _read_log(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_cfg():
    from diff_sal_tpu import config as jc

    return jc.ExperimentConfig(
        model=jc.ModelConfig(
            visual=jc.MViTConfig.tiny(spatial_size=HW), audio=jc.VGGishConfig(),
            spatiotemp=jc.AudioAttnConfig(),
            decoder=jc.SalUNetConfig(img_size=HW, dropout=0.0, drop_path_rate=(0.0,) * 4)),
        optim=jc.OptimConfig(lr=LR))


def jax_side(cfg, variables, inp):
    """JAX's train step and eval step on a 2-device mesh, as
    tests/test_parallel.py runs them: (metrics, state after as port
    state-dict entries, eval scores, eval maps)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from diff_sal_tpu.diffusion.schedule import make_schedule as j_schedule
    from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
    from diff_sal_tpu.parallel.mesh import batch_sharding, make_mesh, shard_batch
    from diff_sal_tpu.train.optim import make_optimizer as j_optimizer
    from diff_sal_tpu.train.train_step import create_train_state
    from diff_sal_tpu.train.train_step import make_eval_step as j_eval
    from diff_sal_tpu.train.train_step import make_train_step as j_train
    from diff_sal_tpu_torch import bridge

    model, sched = JModel(cfg.model), j_schedule()
    tx = j_optimizer(cfg.optim, steps_per_epoch=4, n_epochs=2)
    mesh = make_mesh(num_data=W, devices=jax.devices()[:W])
    repl, data = NamedSharding(mesh, P()), batch_sharding(mesh)
    state = jax.device_put(create_train_state(model, variables, tx), repl)
    batch = shard_batch({k: jnp.asarray(inp[k]) for k in ("rgb", "salmap", "audio")}, mesh)
    step = jax.jit(j_train(model, sched, cfg), in_shardings=(repl, data, repl),
                   out_shardings=(repl, repl))
    new_state, metrics = step(state, batch, jax.random.PRNGKey(int(inp["train_key"])))
    after = bridge.state_dict_from_flax(
        {"params": jax.device_get(new_state.params),
         "batch_stats": jax.device_get(new_state.batch_stats)}, cfg.model.visual.num_layers)
    ev = shard_batch({k: jnp.asarray(inp[f"ev_{k}"]) for k in ("rgb", "salmap", "audio",
                                                                "valid")}, mesh)
    eval_step = jax.jit(j_eval(model, sched, cfg), in_shardings=(repl, data, repl),
                        out_shardings=(repl, data))
    scores, pred = eval_step(state, ev, jax.random.PRNGKey(int(inp["eval_key"])))
    return ({k: float(v) for k, v in metrics.items()}, after,
            {k: float(v) for k, v in scores.items()}, np.asarray(pred))


def flax_batchnorm(inp):
    """flax's BatchNorm (train mode, the port's momentum and eps) on the
    whole batch: output, running statistics, input and parameter
    gradients of sum(y * gy)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x = jnp.asarray(inp["bn_x"])
    variables = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(inp["bn_scale"]), "bias": jnp.asarray(inp["bn_bias"])}

    def loss(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return (y * inp["bn_gy"]).sum(), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, x)
    return {"y": np.asarray(y), "dx": np.asarray(gx), "dscale": np.asarray(gp["scale"]),
            "dbias": np.asarray(gp["bias"]), "mean": np.asarray(stats["mean"]),
            "var": np.asarray(stats["var"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from diff_sal_tpu.diffusion.schedule import make_schedule as j_schedule
    from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
    from diff_sal_tpu_torch import bridge
    from diff_sal_tpu_torch.data.synthetic import write_packed_av_tree
    from test_torch_trainer import flax_like_variables

    work = tmp_path_factory.mktemp("dp")
    cfg = jax_cfg()
    h, w = HW
    shapes = jax.eval_shape(JModel(cfg.model).init, jax.random.PRNGKey(0), {
        "rgb": jax.numpy.zeros((1, 16, h, w, 3)), "input": jax.numpy.zeros((1, h, w, 1)),
        "audio": jax.numpy.zeros((1, 9, h // 2, w // 2, 1))}, jax.numpy.zeros((1,)))
    variables = flax_like_variables(shapes, seed=51)
    torch.save(bridge.state_dict_from_flax(variables, cfg.model.visual.num_layers),
               str(work / "weights.pth"))

    rng = np.random.RandomState(52)
    inp = {"rgb": rng.randn(B_TRAIN, 16, h, w, 3).astype(np.float32),
           "salmap": rng.rand(B_TRAIN, h, w, 1).astype(np.float32),
           "audio": rng.randn(B_TRAIN, 9, h // 2, w // 2, 1).astype(np.float32),
           "ev_rgb": rng.randn(B_EVAL, 16, h, w, 3).astype(np.float32),
           "ev_salmap": rng.rand(B_EVAL, h, w, 1).astype(np.float32),
           "ev_audio": rng.randn(B_EVAL, 9, h // 2, w // 2, 1).astype(np.float32),
           "ev_valid": (np.arange(B_EVAL) < B_EVAL - 1).astype(np.float32),
           "bn_x": (rng.randn(6, 5, 7, 16) * 2 + 0.5).astype(np.float32),
           "bn_gy": rng.randn(6, 5, 7, 16).astype(np.float32),
           "bn_scale": (1 + 0.1 * rng.randn(16)).astype(np.float32),
           "bn_bias": (0.1 * rng.randn(16)).astype(np.float32),
           "train_key": np.asarray(53), "eval_key": np.asarray(54)}
    # the draws JAX's steps make from their keys (train_step.py:85-96;
    # inference.py: x_T from split(rng, 3)[1])
    k_deq, k_t, k_noise, _ = jax.random.split(jax.random.PRNGKey(53), 4)
    T = j_schedule().num_timesteps
    inp["draw_deq"] = np.asarray(jax.random.normal(k_deq, (B_TRAIN, h, w, 1)))
    inp["draw_t"] = np.asarray(jax.random.randint(k_t, (), 0, T))
    inp["draw_noise"] = np.asarray(jax.random.normal(k_noise, (B_TRAIN, h, w, 1)))
    inp["ev_noise"] = np.asarray(jax.random.normal(jax.random.split(
        jax.random.PRNGKey(54), 3)[1], (B_EVAL, h, w, 1)))
    np.savez(str(work / "inputs.npz"), **inp)
    packed = str(work / "packed")
    data_config = write_packed_av_tree(packed, HW, FOLDS, fps=20.0)
    with open(work / "data_config.json", "w") as f:
        json.dump(data_config, f)
    out = work / "out"
    out.mkdir()
    spec = {"inputs": str(work / "inputs.npz"), "weights": str(work / "weights.pth"),
            "packed": packed, "data_config": str(work / "data_config.json"),
            "fit_dp": str(work / "fit_dp"), "fit_single": str(work / "fit_single"),
            "out": str(out), "port": free_port(), "group_timeout": GROUP_TIMEOUT_S}
    with open(work / "spec.json", "w") as f:
        json.dump(spec, f)

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    procs = {role: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(work / "spec.json"), role],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for role in ("0", "1", "single")}
    t0 = time.perf_counter()
    try:
        bn_ref = flax_batchnorm(inp)  # while the workers run
        logs = {}
        for role, p in procs.items():
            left = max(1.0, LAUNCH_TIMEOUT_S - (time.perf_counter() - t0))
            logs[role] = p.communicate(timeout=left)[0]
    finally:
        for p in procs.values():  # a hung or failed rank: end the rest of the group
            if p.poll() is None:
                p.kill()
                p.wait()
    for role, p in procs.items():
        assert p.returncode == 0, f"worker {role} exited {p.returncode}:\n{logs[role][-4000:]}"
    res = {}
    for role in procs:
        with np.load(str(out / f"{role}.npz")) as f:
            res[role] = dict(f)
        os.remove(out / f"{role}.npz")
    print("worker seconds: " + json.dumps({role: {k[8:]: round(float(v), 1) for k, v in r.items()
                                                  if k.startswith("seconds/")}
                                           for role, r in res.items()}))
    # what the fits wrote, then their checkpoints (~0.75 GB each) go
    fits = {}
    for key in ("fit_dp", "fit_single"):
        split = os.path.join(spec[key], "split1")
        weights = os.path.join(split, "weights")
        with open(os.path.join(weights, "best.json")) as f:
            best = json.load(f)
        fits[key] = {"split": sorted(os.listdir(split)), "weights": sorted(os.listdir(weights)),
                     "best": best, "logs": {name: _read_log(os.path.join(split, name))
                                            for name in ("split1.log", "split1_val.log")}}
        for name in fits[key]["weights"]:
            if name.endswith(".pth"):
                os.remove(os.path.join(weights, name))
    return {"ranks": [res["0"], res["1"]], "single": res["single"], "bn": bn_ref,
            "inp": inp, "fits": fits, "cfg": cfg, "variables": variables}


@pytest.fixture(scope="module")
def jax_mesh(runs):
    """JAX's steps on the 2-device mesh (~2 minutes of XLA compiles)."""
    return jax_side(runs["cfg"], runs["variables"], runs["inp"])


def _rl2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-300))


def _interleave(parts):
    """Rank r's rows back at r::W of the global batch."""
    out = np.empty((sum(p.shape[0] for p in parts),) + parts[0].shape[1:], parts[0].dtype)
    for r, p in enumerate(parts):
        out[r::W] = p
    return out


def test_sync_batchnorm_matches_flax_on_the_global_batch(runs):
    ref, ranks = runs["bn"], runs["ranks"]
    np.testing.assert_allclose(_interleave([k["bn/y"] for k in ranks]), ref["y"], atol=1e-5)
    np.testing.assert_allclose(_interleave([k["bn/dx"] for k in ranks]), ref["dx"], atol=1e-5)
    for rank in ranks:
        for key in ("dscale", "dbias", "mean", "var"):
            np.testing.assert_allclose(rank[f"bn/{key}"], ref[key], atol=1e-5, rtol=1e-5,
                                       err_msg=key)


def _tensors(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix) and not k.startswith(prefix + "hash/")}


def assert_ranks_bitwise_equal(r0, r1, prefix):
    """Every tensor under `prefix` the same bytes on both ranks."""
    tag = f"{prefix}/hash/"
    h0, h1 = ({k[len(tag):]: str(v) for k, v in r.items() if k.startswith(tag)}
              for r in (r0, r1))
    assert h0 and h0.keys() == h1.keys()
    differ = [k for k in h0 if h0[k] != h1[k]]
    assert not differ, f"ranks differ: {differ[:5]}"


def test_two_rank_f64_step_equals_one_process(runs):
    """Loss within 1e-12 relative; every parameter, Adam moment and
    BatchNorm statistic within 1e-9 relative L2 (a tensor whose gradient
    is zero up to rounding, as the bias before a BatchNorm: within 1e-12
    absolute); the ranks bitwise equal."""
    single, (r0, r1) = runs["single"], runs["ranks"]
    loss = float(single["f64m/total"])
    # each rank's loss is over its rows; their mean is the global batch's
    mean_loss = (float(r0["f64m/total"]) + float(r1["f64m/total"])) / 2
    assert abs(mean_loss - loss) <= 1e-12 * abs(loss), (mean_loss, loss)
    assert abs(float(r0["f64m/grad_norm"]) - float(single["f64m/grad_norm"])) <= \
        1e-9 * float(single["f64m/grad_norm"])
    assert_ranks_bitwise_equal(r0, r1, "f64")
    ref = _tensors(single, "f64/")
    mu = _tensors(single, "f64/mu/")
    top = max(float(np.abs(v).max()) for v in mu.values())
    noise = {k for k, v in mu.items() if float(np.abs(v).max()) <= 1e-6 * top}
    worst = 0.0
    for key, want in ref.items():
        name = key.split("/", 1)[1]
        got = r0[f"f64/{key}"]
        if name in noise:
            assert float(np.abs(got - want).max()) <= 1e-12, key
            continue
        if want.dtype.kind != "f" or not np.any(want):
            assert np.array_equal(got, want), key
            continue
        worst = max(worst, _rl2(got, want))
        assert _rl2(got, want) <= 1e-9, (key, _rl2(got, want))
    print(f"f64: loss {mean_loss!r} vs {loss!r}; worst relative L2 {worst:.2e}; "
          f"{len(noise)} tensors with a rounding-zero gradient")


@pytest.mark.slow
def test_two_rank_f32_step_matches_jax_on_a_two_device_mesh(runs, jax_mesh):
    metrics, after, _, _ = jax_mesh
    r0, r1 = runs["ranks"]
    loss = (float(r0["f32m/total"]) + float(r1["f32m/total"])) / 2
    np.testing.assert_allclose(loss, metrics["total"], rtol=2e-4)
    assert_ranks_bitwise_equal(r0, r1, "f32")
    worst, stats = 0.0, 0.0
    for name, want in after.items():
        if name.startswith("audio_net."):  # the frozen VGGish
            continue
        got = r0[f"f32/sd/{name}"]
        d = float(np.abs(got - np.asarray(want)).max())
        if name.endswith(("running_mean", "running_var")):
            stats = max(stats, d)
            assert d <= 1e-5 * float(np.abs(want).max()) + 1e-6, (name, d)
        else:
            worst = max(worst, d)
    assert worst < 1e-3, worst
    print(f"f32 vs JAX mesh: loss {loss:.6f} / {metrics['total']:.6f}; parameters max|d| "
          f"{worst:.2e}; BatchNorm statistics max|d| {stats:.2e}")


@pytest.mark.slow
def test_two_rank_eval_step_matches_jax_on_a_two_device_mesh(runs, jax_mesh):
    _, _, scores, pred = jax_mesh
    ranks = runs["ranks"]
    for rank in ranks:
        np.testing.assert_allclose(float(rank["ddim/global/total"]), scores["total"], rtol=2e-4)
    np.testing.assert_allclose(_interleave([k["ddim/pred"] for k in ranks]), pred, atol=1e-4)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_two_rank_eval_step_equals_one_process(runs, sampler):
    """DDIM NFE 1 and DPM-Solver++ 2M NFE 2 on the padded batch: the ranks'
    maps are the one-process run's rows, and the scores reduced over the
    ranks (Σ score·n / Σ n) its scores over the real rows."""
    single, ranks = runs["single"], runs["ranks"]
    np.testing.assert_allclose(_interleave([k[f"{sampler}/pred"] for k in ranks]),
                               single[f"{sampler}/pred"], atol=1e-5)
    for key in ("total", "cc", "sim", "nss", "kl"):
        for rank in ranks:
            np.testing.assert_allclose(float(rank[f"{sampler}/global/{key}"]),
                                       float(single[f"{sampler}/score/{key}"]), rtol=1e-5,
                                       atol=1e-6)


def test_fit_on_two_ranks_over_an_uneven_tree(runs):
    fits, single, (r0, r1) = runs["fits"], runs["single"], runs["ranks"]
    # 5 windows: one process at B=2 takes 2 steps an epoch, each rank as many
    for rank in (r0, r1):
        assert int(rank["fit/count/steps_per_epoch"]) == 2
        assert int(rank["fit/count/steps"]) == int(single["fit/count/steps"]) == 4
    # rank 0 alone writes: 2 logs, a checkpoint and a best-update per epoch
    assert [int(r0[f"fit/count/{k}"]) for k in ("loggers", "saves", "best")] == [2, 2, 2]
    assert [int(r1[f"fit/count/{k}"]) for k in ("loggers", "saves", "best")] == [0, 0, 0]
    dp, one = fits["fit_dp"], fits["fit_single"]
    assert dp["split"] == one["split"] == ["split1.log", "split1_val.log", "weights"]
    assert dp["weights"] == one["weights"] == ["0.pth", "1.pth", "best.json"]
    for name in ("split1.log", "split1_val.log"):
        got, want = dp["logs"][name], one["logs"][name]
        assert len(got) == len(want) == 2
        for g, w_ in zip(got, want):
            assert g.keys() == w_.keys()
            for k in g:
                if k in ("epoch", "total_step", "lr"):
                    assert g[k] == w_[k], (name, k)
                else:
                    a, b = float(g[k]), float(w_[k])
                    assert abs(a - b) <= LOGS * max(abs(b), 1.0), (name, k, a, b)
    assert dp["best"]["step"] == one["best"]["step"]
    assert_ranks_bitwise_equal(r0, r1, "fit")


def test_mesh_units_on_two_ranks(runs):
    for r, rank in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(rank["unit/rows"], np.arange(7)[r::W])
        assert rank["unit/info"].tolist() == [r, W, 1, W]
        assert bool(rank["unit/indivisible_raised"]) and bool(rank["unit/divisible_group"])
        assert int(rank["bn/n_norms"]) == W


def test_make_mesh_for_batch_in_one_process():
    from diff_sal_tpu_torch.parallel import mesh

    assert mesh.make_mesh() is None and mesh.make_mesh_for_batch(3) is None
    with pytest.raises(ValueError):
        mesh.make_mesh(num_data=2)
    with pytest.raises(ValueError, match="make_device_mesh"):
        mesh.make_mesh(num_model=2)  # the model axis is the 2-D mesh's
    assert mesh.shard_batch({"x": [1, 2, 3]}, None) == {"x": [1, 2, 3]}


def test_multihost_single_process(monkeypatch, capsys):
    """JAX's tests/test_utils.py:40-45 on the port's module."""
    from diff_sal_tpu_torch.parallel import multihost

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is None  # no-op in one process
    assert multihost.is_main_process()
    multihost.main_print("hello from rank 0")
    assert "hello from rank 0" in capsys.readouterr().out
    info = multihost.process_info()
    assert info["process_count"] == 1 and info["global_devices"] >= 1
    assert set(info) == {"process_index", "process_count", "local_devices", "global_devices"}
    multihost.shutdown()  # nothing to leave


def test_backend_rule():
    from diff_sal_tpu_torch.parallel import multihost

    assert multihost.choose_backend("cpu", 2)[0] == "gloo"
    assert multihost.rank_device(3, "cpu") == torch.device("cpu")


def test_no_mesh_under_a_launch_of_two_ranks_raises(monkeypatch, tmp_path):
    from diff_sal_tpu_torch import cli

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="--no_mesh"):
        cli.main(["train-av", "--no_mesh", "--device", "cpu", "--packed_root", str(tmp_path),
                  "--workdir", str(tmp_path / "run")])


@pytest.mark.parametrize("n", [9, 10, 11])
def test_loader_cuts_each_epoch_to_a_multiple_of_the_ranks(n):
    """With drop_last every rank yields floor(n / (W b)) batches, as one
    process at batch W b does, and together the ranks' k-th batches are
    that process's k-th batch."""
    from diff_sal_tpu_torch.data.loader import Loader
    from diff_sal_tpu_torch.data.synthetic import SyntheticVisualDataset

    ds = SyntheticVisualDataset(n=n, img_size=(8, 12), frames=2)
    one = Loader(ds, 4, shuffle=True, seed=2, num_workers=0)
    ranks = [Loader(ds, 2, shuffle=True, seed=2, num_workers=0, process_index=r,
                    process_count=W) for r in range(W)]
    for epoch in (0, 3):
        for lo in [one] + ranks:
            lo.set_epoch(epoch)
        want = [list(chunk) for chunk, _ in one._batches()]
        got = [[list(chunk) for chunk, _ in lo._batches()] for lo in ranks]
        assert len(one) == len(want) == n // 4
        assert all(len(lo) == len(g) == n // 4 for lo, g in zip(ranks, got))
        for k, batch in enumerate(want):
            joined = [None] * 4
            for r in range(W):
                joined[r::W] = got[r][k]
            assert joined == batch


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], sys.argv[2]))
