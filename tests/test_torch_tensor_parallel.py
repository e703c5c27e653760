"""Tensor-parallel sharding of the port (`parallel/tensor.py`,
`parallel/mesh.make_device_mesh`) on the CPU: four gloo ranks as a
(2 data x 2 model) mesh.

One module fixture launches everything: four ranks of this file run as a
script (`python tests/test_torch_tensor_parallel.py <spec> <rank>`, a
process group over tcp://127.0.0.1 on a free port) and a fifth process
runs the one-process references (`... <spec> single`), while the test
process computes JAX's side on the conftest's CPU devices. Each process
runs on one torch thread and writes its results; the launch has a
subprocess timeout and the process group a timeout of its own, so a hang
fails the fixture and cannot eat the suite's time. The workers import
torch, numpy and the port only.

The cases:
1. the rule: JAX's `tensor_parallel_param_shardings` on the full AV
   model's variables (`jax.eval_shape` of its init) over (2, 2) and (1, 4)
   meshes shards 107 leaves, and the bridge carries them onto exactly the
   port's sharded `state_dict` entries; likewise at `min_dim=1024` and on a
   model axis of 3 (nothing indivisible sharded). Each entry's axis is
   checked through the bridge itself: every flax leaf filled with its
   index along its last axis, exported, and the varying torch axis read;
2. AudioAttnNet (`AudioAttnConfig()`, x (2, 9, 7, 12, 512) x 0.3) sharded
   on the 2 x 2 ranks against JAX's sharded `jit` forward on a (2, 2) mesh
   (atol 2e-5, JAX's own bound in tests/test_parallel.py), and the input
   and parameter gradients of sum(out * r) / 2 (the ranks average over
   'data') against `jax.grad` on the same mesh (1e-5 relative L2);
3. the small AV model (MViT tiny, VGGish, AudioAttnNet, SalUNet at 64x96,
   decoder dropout and DropPath 0), global B=2 (a row per data rank): DDIM
   NFE 1 on the 2 x 2 ranks against the port's one-process run in f32
   (1e-5), at `min_dim` 256 and 64 (64 also shards the rel-pos tables, the
   cls token, MViT's pools and stem, which go through `full`); one loss
   backward in f64 (the gradients averaged over 'data', the shards
   gathered) against one process (1e-9 relative L2 per tensor,
   tests/test_torch_parallel.py's f64 bound), every rank's gathered gradients bitwise equal;
4. the units: `make_device_mesh`'s coordinates and its refusals, each
   rank's parameter bytes as the rule predicts, kernel wrappers refusing a
   DTensor, the tiny MViT with w8 MLPs (int8 `weight_q` sharded as JAX's
   `kernel_q`, scales replicated) sharded against whole,
   `MeshConfig(num_model=2)` accepted, `make_mesh(num_model=2)`
   naming `make_device_mesh`, and the trainer with `num_model=2`
   data-parallel over every rank, as JAX's trainer over every device.
"""

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
NUM_DATA, NUM_MODEL = 2, 2
W = NUM_DATA * NUM_MODEL
B = 2                     # global: one row per data rank
T_STEP = 300              # the backward's timestep
LAUNCH_TIMEOUT_S = 240    # the whole launch (ranks and one-process references)
GROUP_TIMEOUT_S = 180     # each collective
MIN_DIMS = (256, 64)
AUDIO_SHAPE = (2, 9, 7, 12, 512)


def model_cfg():
    """The small AV experiment, decoder dropout and DropPath 0 (the
    backward draws no mask)."""
    from diff_sal_tpu_torch import config as pc

    return pc.ExperimentConfig(model=pc.ModelConfig(
        visual=pc.MViTConfig.tiny(spatial_size=HW), audio=pc.VGGishConfig(),
        spatiotemp=pc.AudioAttnConfig(),
        decoder=pc.SalUNetConfig(img_size=HW, dropout=0.0, drop_path_rate=(0.0,) * 4)))


# -- the worker: a rank, or the one-process references -----------------------


def small_model(cfg, double=False):
    """The small AV model from seed 0 with every bias, norm and BatchNorm
    statistic moved off its initial value (a torch generator on the CPU:
    the same on every process)."""
    from diff_sal_tpu_torch.models.diff_model import build_model

    model = build_model(cfg.model, seed=0, device="cpu")
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dtype == torch.float32 and t.ndim == 1:
                r = torch.randn(t.shape, generator=g)
                t.copy_(0.5 + 0.5 * r.abs() if name.endswith("running_var") else t + 0.05 * r)
    return model.double() if double else model


def _rows(a, d, dmesh):
    return a if dmesh is None else a[d::NUM_DATA]


def case_maps(cfg, inp, dmesh, d):
    """DDIM NFE 1 on this data rank's row (or the whole batch), the model
    sharded at each of MIN_DIMS (once, unsharded, in one process)."""
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.parallel import tensor

    out = {}
    for min_dim in (MIN_DIMS if dmesh is not None else (None,)):
        model = small_model(cfg)
        if dmesh is not None:
            tensor.shard_model(model, dmesh, min_dim)
            out[f"bytes{min_dim}"] = np.asarray(tensor.local_bytes(model))
        x = {k: torch.from_numpy(_rows(inp[k], d, dmesh)) for k in ("rgb", "audio", "noise")}
        with torch.no_grad():
            pred = sample_saliency(model, make_schedule(), cfg.sampling, cfg.data_transform,
                                   x["rgb"], x["audio"], noise=x["noise"])
        out[f"map{min_dim}"] = pred.numpy()
    return out


def case_backward(cfg, inp, dmesh, d, out_dir, role):
    """One f64 loss backward (MSE on x0 at T_STEP, train mode, BatchNorm
    statistics over the global batch), the gradients averaged over 'data'
    and the shards gathered: rank 0 and the one process save them, every
    rank their digests."""
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule, q_sample
    from diff_sal_tpu_torch.parallel import mesh, tensor
    from diff_sal_tpu_torch.train.losses import training_loss

    model = small_model(cfg, double=True).train()
    x = {k: torch.from_numpy(inp[k]).double() for k in ("rgb", "audio", "noise", "salmap")}
    if dmesh is not None:
        tensor.shard_model(model, dmesh)
        data = dmesh.get_group("data")
        model.set_stats_group(data)
        x = mesh.shard_batch(x, data)  # rows d::2, the same on both model ranks
    t = torch.full((x["rgb"].shape[0],), T_STEP)
    x_noisy = q_sample(make_schedule(), x["salmap"], t, x["noise"])
    pred = model({"rgb": x["rgb"], "input": x_noisy, "audio": x["audio"]}, t.double(),
                 train=True)
    training_loss(cfg.loss, pred, x["salmap"])["total"].backward()
    if dmesh is not None:
        mesh.average_gradients(list(model.parameters()), data)
    with torch.no_grad():
        grads = {n: tensor.full(p.grad) for n, p in model.named_parameters()
                 if p.grad is not None}
    if role in ("0", "single"):
        torch.save(grads, os.path.join(out_dir, f"grads_{role}.pt"))
    h = hashlib.sha256()
    for n in sorted(grads):
        h.update(n.encode() + grads[n].numpy().tobytes())
    sharded = sorted(n for n, p in model.named_parameters() if tensor.is_sharded(p))
    return {"grad_digest": np.asarray(h.hexdigest()), "n_sharded": np.asarray(len(sharded))}


def case_audio_attn(inp, dmesh, d):
    """Case 2 on this rank: AudioAttnNet sharded at min_dim 256, its output
    rows, the input's gradient and (rank 0) the parameters' gradients of
    sum(out * r) over this rank's rows, averaged over 'data'."""
    from diff_sal_tpu_torch.config import AudioAttnConfig
    from diff_sal_tpu_torch.models.audio_attention import AudioAttnNet
    from diff_sal_tpu_torch.parallel import mesh, tensor

    net = AudioAttnNet(AudioAttnConfig())
    net.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in inp.items()
                         if k.startswith("aa/")})
    tensor.shard_model(net, dmesh)
    x = torch.from_numpy(_rows(inp["aa_x"], d, dmesh)).requires_grad_(True)
    y = net(x)
    (y * torch.from_numpy(_rows(inp["aa_r"], d, dmesh))).sum().backward()
    mesh.average_gradients(list(net.parameters()), dmesh.get_group("data"))
    out = {"aa/out": y.detach().numpy(), "aa/dx": x.grad.numpy(),
           "aa/n_sharded": np.asarray(sum(tensor.is_sharded(p) for p in net.parameters()))}
    with torch.no_grad():
        out.update({f"aa/grad/{n}": tensor.full(p.grad).numpy()
                    for n, p in net.named_parameters()})
    return out


def case_quant_mvit(inp, dmesh, d):
    """The tiny MViT with w8 MLPs (int8 `weight_q` buffers, sharded by the
    rule like JAX's quantised kernels; their per-row scales replicated) on
    this data rank's row, sharded and whole: max|d| of the pyramid."""
    from diff_sal_tpu_torch.config import MViTConfig
    from diff_sal_tpu_torch.models.diff_model import init_weights
    from diff_sal_tpu_torch.models.mvit import MViT
    from diff_sal_tpu_torch.ops.quant import quantize_state_dict
    from diff_sal_tpu_torch.parallel import tensor

    fp = init_weights(MViT(MViTConfig.tiny(spatial_size=HW)), seed=3).state_dict()
    models = []
    for _ in range(2):
        m = MViT(MViTConfig.tiny(spatial_size=HW, mlp_quant="w8")).eval()
        m.load_state_dict(quantize_state_dict(fp, m.state_dict()))
        models.append(m)
    tensor.shard_model(models[1], dmesh)
    rgb = torch.from_numpy(_rows(inp["rgb"], d, dmesh))
    with torch.no_grad():
        whole, sharded = (m(rgb) for m in models)
    q = [n for n, t in models[1].state_dict().items() if tensor.is_sharded(t)]
    return {"quant/max_d": np.asarray(max(float((a - b).abs().max())
                                           for a, b in zip(whole, sharded))),
            "quant/n_weight_q": np.asarray(sum(n.endswith(".weight_q") for n in q)),
            "quant/n_scale": np.asarray(sum(n.endswith(".weight_scale") for n in q))}


def case_units(cfg, dmesh, r):
    """Case 4's parts that need the process group."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from diff_sal_tpu_torch import config as pc
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel
    from diff_sal_tpu_torch.ops import attention, layernorm, mlp, pool, resize
    from diff_sal_tpu_torch.parallel import mesh, tensor
    from diff_sal_tpu_torch.train import trainer

    out = {"unit/coord": np.asarray(dmesh.get_coordinate()),
           "unit/data_ranks": np.asarray(dist.get_process_group_ranks(dmesh.get_group("data"))),
           "unit/model_ranks": np.asarray(
               dist.get_process_group_ranks(dmesh.get_group("model")))}
    refused = []
    for args in ((3, 2), (-1, 3), (1, 2)):
        try:
            mesh.make_device_mesh(*args, device_type="cpu")
        except ValueError:
            refused.append(args)
    out["unit/refused"] = np.asarray(refused)
    # the placements on the mesh: the rule's axes, Replicate on 'data'
    with torch.device("meta"):
        m = VideoSaliencyModel(cfg.model)
    pl = tensor.tensor_parallel_param_shardings(m, dmesh)
    axes = tensor.tensor_parallel_axes(m, NUM_MODEL)
    out["unit/placements_agree"] = np.asarray(pl.keys() == axes.keys() and all(
        pl[n] == (Replicate(), Replicate() if a is None else Shard(a)) for n, a in axes.items()))
    sd = m.state_dict()
    whole = sum(t.numel() * t.element_size() for t in sd.values())
    out["unit/predicted_bytes"] = np.asarray(whole - sum(
        sd[n].numel() * sd[n].element_size() for n, a in axes.items() if a is not None)
        * (NUM_MODEL - 1) // NUM_MODEL)
    out["unit/whole_bytes"] = np.asarray(whole)
    # every kernel wrapper refuses a DTensor
    lin = torch.nn.Linear(512, 512)
    w = DTensor.from_local(lin.weight.detach()[:256].clone(), dmesh, (Replicate(), Shard(0)),
                           run_check=False)
    x = torch.randn(8, 512)
    calls = {  # shapes aside: the refusal comes first
        "layer_norm": lambda: layernorm.layer_norm_fwd(x, w, x[0]),
        "block_tail": lambda: mlp.block_tail(x, x, x[0], x[0], w, x[0], w, x[0]),
        "bilinear_resize_sum": lambda: resize.bilinear_resize_sum_fwd([x, w], (8, 8)),
        "depthwise_pool3d": lambda: pool.pool_fwd(x, w, (1, 1, 1)),
        "cvt_cross_attention": lambda: attention.cvt_cross_attention(x, w, x, 2, 1.0),
        "bias_attention": lambda: attention.bias_attention_fwd(x, x, x, w, (1, 2, 4), 2, 1.0),
    }
    for name, call in calls.items():
        try:
            call()
            out[f"unit/refuses/{name}"] = np.asarray(False)
        except TypeError as e:
            out[f"unit/refuses/{name}"] = np.asarray("DTensor" in str(e))
    # the trainer with a model axis in its config: data-parallel over every rank
    cfg2 = pc.ExperimentConfig(model=cfg.model, mesh=pc.MeshConfig(num_model=2),
                               training=pc.TrainingConfig(batch_size=4))
    t = trainer.Trainer(cfg2, os.path.join(os.environ["TP_WORK"], f"trainer{r}"), 1,
                        device="cpu", group=dist.group.WORLD)
    out["unit/trainer_ranks"] = np.asarray(mesh.world_size(t.group))
    out["unit/loader_batch"] = np.asarray(trainer.rank_loader_kwargs(cfg2, t.group)["batch_size"])
    return out


def worker(spec_path: str, role: str) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    os.environ["TP_WORK"] = spec["work"]
    inp = dict(np.load(spec["inputs"]))
    cfg = model_cfg()
    out = {}
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out.update(fn(*args))
        out[f"seconds/{name}"] = np.asarray(time.perf_counter() - t)

    if role == "single":
        timed("maps", case_maps, cfg, inp, None, 0)
        timed("backward", case_backward, cfg, inp, None, 0, spec["out"], role)
    else:
        from diff_sal_tpu_torch.parallel import mesh, multihost

        r = int(role)
        multihost.initialize(init_method=f"tcp://127.0.0.1:{spec['port']}", world_size=W,
                             rank=r, device="cpu", timeout_s=spec["group_timeout"])
        try:
            dmesh = mesh.make_device_mesh(NUM_DATA, NUM_MODEL, device_type="cpu")
            d = dmesh.get_coordinate()[0]
            timed("units", case_units, cfg, dmesh, r)
            timed("audio_attn", case_audio_attn, inp, dmesh, d)
            timed("quant", case_quant_mvit, inp, dmesh, d)
            timed("maps", case_maps, cfg, inp, dmesh, d)
            timed("backward", case_backward, cfg, inp, dmesh, d, spec["out"], role)
        finally:
            multihost.shutdown()
    out["seconds/all"] = np.asarray(time.perf_counter() - t0)
    np.savez(os.path.join(spec["out"], f"{role}.npz"), **out)
    return 0


# -- the launch and JAX's side -------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def audio_attn_variables():
    """JAX's AudioAttnNet variables with random values (numpy seed 61)."""
    import jax

    from diff_sal_tpu.config import AudioAttnConfig
    from diff_sal_tpu.models.audio_attention import AudioAttnNet
    from test_torch_models import random_variables

    model = AudioAttnNet(AudioAttnConfig())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros(AUDIO_SHAPE, jax.numpy.float32))
    return model, random_variables(shapes, seed=61)


def jax_audio_attn(model, variables, x, r):
    """JAX's forward and gradients with the parameters sharded by its rule
    on a (2, 2) mesh, as tests/test_parallel.py runs the forward."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from diff_sal_tpu.parallel.mesh import make_mesh, tensor_parallel_param_shardings

    mesh = make_mesh(num_data=NUM_DATA, num_model=NUM_MODEL, devices=jax.devices()[:W])
    shardings = tensor_parallel_param_shardings(variables, mesh)
    tp_vars = jax.device_put(variables, shardings)
    xd = jax.device_put(x, NamedSharding(mesh, P("data")))
    repl = NamedSharding(mesh, P())
    out = jax.jit(model.apply, out_shardings=repl)(tp_vars, xd)

    def loss(v, x):
        return (model.apply(v, x) * r).sum() / NUM_DATA

    gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)), out_shardings=(shardings, repl))(
        tp_vars, xd)
    n_sharded = sum(s.spec != P() for s in jax.tree.leaves(shardings))
    return (np.asarray(out), np.asarray(model.apply(variables, x)), jax.device_get(gv),
            np.asarray(gx), n_sharded)


# the rule's cases: (mesh shape, min_dim)
RULE_CASES = {"2x2": ((2, 2), 256), "1x4": ((1, 4), 256), "model3": ((1, 3), 256),
              "min1024": ((2, 2), 1024)}


def jax_rule_sides():
    """JAX's rule on the full AV model's variables in each RULE_CASES case,
    carried through the bridge: the port names of the sharded leaves, and
    the torch axis each leaf's last axis lands on (from an export of every
    leaf filled with its index along that axis)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from diff_sal_tpu import config as jc
    from diff_sal_tpu.models.diff_model import VideoSaliencyModel as JModel
    from diff_sal_tpu.models.mvit import MViT as JMViT
    from diff_sal_tpu.parallel.mesh import make_mesh, tensor_parallel_param_shardings
    from diff_sal_tpu_torch import bridge

    cfg = jc.ModelConfig.audio_visual()
    (h, w), T = cfg.decoder.img_size, cfg.visual.temporal_size
    zeros = jax.numpy.zeros
    shapes = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0), {
        "rgb": zeros((1, T, h, w, 3)), "input": zeros((1, h, w, 1)),
        "audio": zeros((1, 9, h // 2, w // 2, 1))}, zeros((1,)))

    def export(fill, *trees):
        sd = bridge.state_dict_from_flax(jax.tree.map(fill, shapes, *trees),
                                         cfg.visual.num_layers)
        return {k: v.numpy() for k, v in sd.items()}

    sides = {}
    for case, ((nd, nm), min_dim) in RULE_CASES.items():
        mesh = make_mesh(nd, nm, devices=jax.devices()[:nd * nm])
        on = jax.tree.map(lambda sh: sh.spec != P(),
                          tensor_parallel_param_shardings(shapes, mesh, min_dim))
        sd = export(lambda s, o: np.full(s.shape, o, np.int8), on)
        sides[case] = {"names": {k for k, v in sd.items() if bool(v.any())},
                       "n_leaves": sum(jax.tree.leaves(on))}
    # the tiny MViT with w8 MLPs: kernel_q (I, O) int8 sharded, its scales not
    mcfg = jc.MViTConfig.tiny(spatial_size=HW, mlp_quant="w8")
    mshapes = jax.eval_shape(JMViT(mcfg).init, jax.random.PRNGKey(0),
                             zeros((1, mcfg.temporal_size, *HW, 3)))
    mesh = make_mesh(NUM_DATA, NUM_MODEL, devices=jax.devices()[:W])
    on = jax.tree.map(lambda sh: sh.spec != P(), tensor_parallel_param_shardings(mshapes, mesh))
    sd = bridge.export_mvit(jax.tree.map(lambda s, o: np.full(s.shape, o, np.int8), mshapes,
                                         on)["params"], mcfg.num_layers)
    sides["mvit_w8"] = {"names": {k for k, v in sd.items() if bool(v.any())},
                        "n_leaves": sum(jax.tree.leaves(on))}
    index = export(lambda s: np.array(np.broadcast_to(
        np.arange(1, s.shape[-1] + 1, dtype=np.int16) if s.ndim else np.int16(0), s.shape)))
    return sides, index


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    aa_model, aa_vars = audio_attn_variables()
    from diff_sal_tpu_torch import bridge

    rng = np.random.RandomState(62)
    h, w = HW
    inp = {"aa_x": (rng.randn(*AUDIO_SHAPE) * 0.3).astype(np.float32),
           "aa_r": rng.randn(*AUDIO_SHAPE).astype(np.float32),
           "rgb": rng.randn(B, 16, h, w, 3).astype(np.float32),
           "audio": rng.randn(B, 9, h // 2, w // 2, 1).astype(np.float32),
           "noise": rng.randn(B, h, w, 1).astype(np.float32),
           "salmap": rng.rand(B, h, w, 1).astype(np.float32)}
    inp.update({f"aa/{k}": v for k, v in bridge.export_audio_attn(aa_vars["params"]).items()})
    np.savez(str(work / "inputs.npz"), **inp)
    out = work / "out"
    out.mkdir()
    spec = {"inputs": str(work / "inputs.npz"), "out": str(out), "work": str(work),
            "port": free_port(), "group_timeout": GROUP_TIMEOUT_S}
    with open(work / "spec.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    roles = [str(r) for r in range(W)] + ["single"]
    procs = {role: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(work / "spec.json"), role],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for role in roles}
    t0 = time.perf_counter()
    try:
        jax_aa = jax_audio_attn(aa_model, aa_vars, inp["aa_x"], inp["aa_r"])  # meanwhile
        rule, index = jax_rule_sides()
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
    for role in roles:
        with np.load(str(out / f"{role}.npz")) as f:
            res[role] = dict(f)
    grads = {}
    for role in ("0", "single"):
        path = out / f"grads_{role}.pt"
        grads[role] = torch.load(str(path), weights_only=True)
        os.remove(path)
    print("worker seconds: " + json.dumps({role: {k[8:]: round(float(v), 1) for k, v in r.items()
                                                  if k.startswith("seconds/")}
                                           for role, r in res.items()}))
    return {"ranks": [res[str(r)] for r in range(W)], "single": res["single"], "grads": grads,
            "inp": inp, "jax_aa": jax_aa, "aa_vars": aa_vars, "rule": rule, "index": index}


def _rl2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _data_rows(ranks, key):
    """The global batch from the data ranks' rows (model rank 0 of each
    data row; the model ranks' copies checked equal)."""
    parts = []
    for d in range(NUM_DATA):
        row = [ranks[d * NUM_MODEL + m][key] for m in range(NUM_MODEL)]
        for other in row[1:]:
            np.testing.assert_array_equal(other, row[0])
        parts.append(row[0])
    out = np.empty((sum(p.shape[0] for p in parts),) + parts[0].shape[1:], parts[0].dtype)
    for d, p in enumerate(parts):
        out[d::NUM_DATA] = p
    return out


@pytest.fixture(scope="module")
def port_full_model():
    from diff_sal_tpu_torch.config import ModelConfig
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel

    with torch.device("meta"):
        return VideoSaliencyModel(ModelConfig.audio_visual())


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_matches_jax_through_the_bridge(runs, port_full_model, case):
    """The port's sharded entries are JAX's sharded leaves, carried by the
    bridge (107 on the full AV model at min_dim 256, model axis 2 or 4),
    each sharded along the torch axis the bridge moves the leaf's last
    axis to (0: output features)."""
    from diff_sal_tpu_torch.parallel import tensor

    (_, n_model), min_dim = RULE_CASES[case]
    axes = tensor.tensor_parallel_axes(port_full_model, n_model, min_dim)
    port = {n for n, a in axes.items() if a is not None}
    jax_side = runs["rule"][case]
    assert port == jax_side["names"], sorted(port ^ jax_side["names"])[:10]
    assert len(port) == jax_side["n_leaves"]
    if min_dim == 256 and n_model in (2, 4):
        assert len(port) == 107
    sd = port_full_model.state_dict()
    for n in port:
        assert sd[n].shape[axes[n]] % n_model == 0 and sd[n].shape[axes[n]] >= min_dim, n
        t = runs["index"][n]
        nz = t != 0
        idx = np.arange(1, t.shape[axes[n]] + 1).reshape(
            [-1 if i == axes[n] else 1 for i in range(t.ndim)])
        assert np.array_equal(t[nz], np.broadcast_to(idx, t.shape)[nz]), n
        assert set(np.unique(t[nz])) == set(range(1, t.shape[axes[n]] + 1)), n
    assert {axes[n] for n in port} <= {0}


def test_rule_on_quantised_mlps_matches_jax(runs):
    """w8 MLPs: the int8 `weight_q` (out, in) follows JAX's rule like its
    (in, out) `kernel_q`, the per-row scales stay replicated; the sharded
    quantised MViT computes the whole one's pyramid."""
    from diff_sal_tpu_torch.config import MViTConfig
    from diff_sal_tpu_torch.models.mvit import MViT
    from diff_sal_tpu_torch.parallel import tensor

    with torch.device("meta"):
        m = MViT(MViTConfig.tiny(spatial_size=HW, mlp_quant="w8"))
    axes = tensor.tensor_parallel_axes(m, NUM_MODEL)
    port = {n for n, a in axes.items() if a is not None}
    assert port == runs["rule"]["mvit_w8"]["names"], sorted(port ^ runs["rule"]["mvit_w8"]["names"])
    assert any(n.endswith(".weight_q") for n in port)
    assert not any(n.endswith(".weight_scale") for n in port)
    for r in runs["ranks"]:
        assert int(r["quant/n_weight_q"]) > 0 and int(r["quant/n_scale"]) == 0
        assert float(r["quant/max_d"]) <= 1e-5, float(r["quant/max_d"])


def test_audio_attn_sharded_forward_matches_jax(runs):
    out, ref, _, _, n_sharded = runs["jax_aa"]
    got = _data_rows(runs["ranks"], "aa/out")
    np.testing.assert_allclose(out, ref, atol=2e-5)  # JAX's own check
    print(f"AudioAttnNet sharded vs JAX's sharded forward: max|d| {np.abs(got - out).max():.2e}")
    np.testing.assert_allclose(got, out, atol=2e-5)
    assert n_sharded == 4 and all(int(r["aa/n_sharded"]) == 4 for r in runs["ranks"])


def test_audio_attn_sharded_gradients_match_jax(runs):
    """Input and parameter gradients of sum(out * r) / 2: each data rank's
    input gradient is of its own rows' sum, twice JAX's share."""
    from diff_sal_tpu_torch import bridge

    _, _, gv, gx, _ = runs["jax_aa"]
    dx = _data_rows(runs["ranks"], "aa/dx") / NUM_DATA
    want = bridge.export_audio_attn(gv["params"])
    worst = 0.0
    for r in runs["ranks"]:
        got = {k[len("aa/grad/"):]: v for k, v in r.items() if k.startswith("aa/grad/")}
        assert got.keys() == want.keys()
        for k in want:
            assert _rl2(got[k], want[k]) <= 1e-5, (k, _rl2(got[k], want[k]))
            worst = max(worst, _rl2(got[k], want[k]))
    print(f"AudioAttnNet gradients vs jax.grad: input {_rl2(dx, gx):.2e}, parameters worst "
          f"{worst:.2e} (relative L2)")
    assert _rl2(dx, gx) <= 1e-5


@pytest.mark.parametrize("min_dim", MIN_DIMS)
def test_small_av_map_on_2x2_ranks_matches_one_process(runs, min_dim):
    got = _data_rows(runs["ranks"], f"map{min_dim}")
    ref = runs["single"]["mapNone"]
    assert got.shape == ref.shape == (B, *HW, 1)
    print(f"min_dim {min_dim}: map max|d| {np.abs(got - ref).max():.2e}")
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_small_av_f64_gradients_on_2x2_ranks(runs):
    """Per tensor within 1e-9 relative L2; tensors whose gradient is zero up
    to rounding (below 1e-6 of the largest: a conv bias before a
    batch-statistics BatchNorm) within 1e-12 absolute, as
    tests/test_torch_parallel.py holds them."""
    got, ref = runs["grads"]["0"], runs["grads"]["single"]
    assert got.keys() == ref.keys() and got
    top = max(float(g.abs().max()) for g in ref.values())
    live = [n for n in ref if float(ref[n].abs().max()) > 1e-6 * top]
    worst = max((_rl2(got[n].numpy(), ref[n].numpy()), n) for n in live)
    print(f"f64 gradients: worst relative L2 {worst}")
    assert worst[0] <= 1e-9, worst
    for n in set(ref) - set(live):
        assert float((got[n] - ref[n]).abs().max()) <= 1e-12, n
    digests = {str(r["grad_digest"]) for r in runs["ranks"]}
    assert len(digests) == 1, "the ranks' gathered gradients differ"
    assert all(int(r["n_sharded"]) > 0 for r in runs["ranks"])


def test_device_mesh_coordinates_and_refusals(runs):
    for r, res in enumerate(runs["ranks"]):
        assert tuple(res["unit/coord"]) == (r // NUM_MODEL, r % NUM_MODEL)
        assert list(res["unit/data_ranks"]) == [r % NUM_MODEL + NUM_MODEL * d
                                               for d in range(NUM_DATA)]
        assert list(res["unit/model_ranks"]) == [(r // NUM_MODEL) * NUM_MODEL + m
                                                for m in range(NUM_MODEL)]
        assert [tuple(a) for a in res["unit/refused"]] == [(3, 2), (-1, 3), (1, 2)]
        assert bool(res["unit/placements_agree"])


def test_each_rank_holds_the_bytes_the_rule_predicts(runs):
    """The small AV model sharded at min_dim 256: each rank's parameters
    and buffers as the rule predicts, below the whole model's."""
    for res in runs["ranks"]:
        assert int(res["bytes256"]) == int(res["unit/predicted_bytes"])
        assert int(res["bytes256"]) < int(res["unit/whole_bytes"])
        assert int(res["bytes64"]) < int(res["bytes256"])


@pytest.mark.parametrize("wrapper", ["layer_norm", "block_tail", "bilinear_resize_sum",
                                     "depthwise_pool3d", "cvt_cross_attention",
                                     "bias_attention"])
def test_kernel_wrappers_refuse_a_dtensor(runs, wrapper):
    assert all(bool(r[f"unit/refuses/{wrapper}"]) for r in runs["ranks"])


def test_trainer_with_a_model_axis_is_data_parallel_over_every_rank(runs, tmp_path):
    """JAX's trainer builds its mesh from the batch alone (trainer.py:80):
    with num_model=2 it runs data-parallel over every device. The port's
    runs over every rank alike, and in one process as one process."""
    import jax

    from diff_sal_tpu import config as jc
    from diff_sal_tpu.train.trainer import Trainer as JTrainer
    from diff_sal_tpu_torch import config as pc
    from diff_sal_tpu_torch.train import trainer

    jcfg = jc.ExperimentConfig(mesh=jc.MeshConfig(num_model=2),
                               training=jc.TrainingConfig(batch_size=8))
    jt = JTrainer(jcfg, str(tmp_path / "jax"), steps_per_epoch=1)
    assert dict(jt.mesh.shape) == {"data": len(jax.devices()), "model": 1}
    for r in runs["ranks"]:
        assert int(r["unit/trainer_ranks"]) == W and int(r["unit/loader_batch"]) == 4 // W
    cfg = pc.ExperimentConfig(mesh=pc.MeshConfig(num_model=2))
    t = trainer.Trainer(cfg, str(tmp_path / "port"), 1, device="cpu")
    assert t.group is None
    assert trainer.rank_loader_kwargs(cfg) == {"batch_size": cfg.training.batch_size}


def test_mesh_config_and_make_mesh_with_a_model_axis():
    from diff_sal_tpu_torch.config import MeshConfig
    from diff_sal_tpu_torch.parallel import mesh

    assert MeshConfig(num_model=2).num_model == 2
    with pytest.raises(ValueError, match="make_device_mesh"):
        mesh.make_mesh(num_model=2)
    with pytest.raises(ValueError, match="process group"):
        mesh.make_device_mesh(1, 1, device_type="cpu")


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], sys.argv[2]))
