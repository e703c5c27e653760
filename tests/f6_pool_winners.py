"""Fault F6 measured: are MViT's max-pooled skip winners decided by f32
rounding? Not a test (pytest collects only test_*.py); run it from the
repository root, on the CPU (a few minutes, two JAX compiles):

    JAX_PLATFORMS=cpu python tests/f6_pool_winners.py

It records the pre-pool tensors and the winners of every strided skip max
pool in the port's f64 step, the port's f32 step and JAX's f32 step (the
small AV model of tests/test_torch_train_step.py, ReLU branches pinned as
there), prints per pool how many windows' winners differ from the f64
step's and those windows' f64 top-two gap over the tensor's largest |x|,
then reruns JAX's f32 step and the port's with the f64 winners pinned and
prints the per-leaf relative L2 gaps from the f64 step, unpinned and
pinned (`visual_net.blocks.8.proj.weight` first)."""
import contextlib
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import flax.linen as flax_nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_train_step as T  # noqa: E402
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule  # noqa: E402
from diff_sal_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from diff_sal_tpu.train.train_step import create_train_state  # noqa: E402
from diff_sal_tpu.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from diff_sal_tpu_torch import bridge  # noqa: E402

POOLS = {"f64": [], "f32": [], "jax": {}}  # (input values (B,T,H,W,C) f64 np, winners flat)


@contextlib.contextmanager
def torch_pools(store, pinned=None):
    orig = F.max_pool3d
    queue = list(pinned) if pinned is not None else None

    def pool(x, kernel, stride, padding, **kw):
        out, idx = orig(x, kernel, stride, padding, return_indices=True)
        store.append((x.detach().double().permute(0, 2, 3, 4, 1).numpy(),
                      idx.permute(0, 2, 3, 4, 1).numpy()))
        if queue is None:
            return out
        win = torch.from_numpy(queue.pop(0)).permute(0, 4, 1, 2, 3)
        B, C = x.shape[:2]
        return x.reshape(B, C, -1).gather(2, win.reshape(B, C, -1)).reshape(out.shape)
    F.max_pool3d = pool
    try:
        yield
    finally:
        F.max_pool3d = orig


@contextlib.contextmanager
def jax_pools(store, pinned=None):
    orig = flax_nn.max_pool
    queue = list(pinned) if pinned is not None else None

    def pool(x, window_shape, strides=None, padding="VALID"):
        jax.debug.callback(lambda v: store.setdefault(tuple(v.shape), np.asarray(v, np.float64)), x)
        out = orig(x, window_shape, strides=strides, padding=padding)
        if queue is None or x.ndim != 5:
            return out
        win = jnp.asarray(queue.pop(0))  # (B, To, Ho, Wo, C) flat T*H*W index
        B, C = x.shape[0], x.shape[-1]
        got = jnp.take_along_axis(x.reshape(B, -1, C), win.reshape(B, -1, C), axis=1)
        return got.reshape(out.shape)
    flax_nn.max_pool = pool
    import diff_sal_tpu.models.mvit as jm
    jm.nn.max_pool = pool
    try:
        yield
    finally:
        flax_nn.max_pool = orig
        jm.nn.max_pool = orig


def winners(x, stride=(1, 2, 2)):
    t = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    kernel = tuple(s + 1 if s > 1 else s for s in stride)
    _, idx = F.max_pool3d(t, kernel, stride, tuple(k // 2 for k in kernel), return_indices=True)
    return idx.permute(0, 2, 3, 4, 1).numpy()


def top2_gap(x64, stride=(1, 2, 2)):
    """Per window: (max - second) / max|x| of the f64 values."""
    t = torch.from_numpy(x64).permute(0, 4, 1, 2, 3)
    B, C, Tn, H, W = t.shape
    tp = F.pad(t, (1, 1, 1, 1), value=-float("inf"))
    wins = torch.stack([tp[..., kh:kh + H:2, kw:kw + W:2][..., :(H - 1) // 2 + 1, :(W - 1) // 2 + 1]
                        for kh in range(3) for kw in range(3)], 0)
    top = wins.topk(2, dim=0).values
    return ((top[0] - top[1]) / t.abs().max()).permute(0, 2, 3, 4, 1).numpy()


def jax_step(cfg, jmodel, variables, batch, key, branches, pools, pinned=None):
    tx = optax.chain(T._stash_grads(), j_make_optimizer(cfg.optim, steps_per_epoch=4, n_epochs=2))
    state = create_train_state(jmodel, variables, tx)
    with T.ReluBranches.pinned_jax(branches), jax_pools(pools, pinned):
        new_state, metrics = jax.jit(j_make_train_step(jmodel, j_make_schedule(), cfg))(
            state, jax.tree.map(jnp.asarray, batch), key)
        jax.effects_barrier()
    return bridge.state_dict_from_flax({"params": jax.device_get(new_state.opt_state[0])},
                                       cfg.model.visual.num_layers)


def gaps(grads, ref, names=None):
    out = {}
    top = max(float(v.abs().max()) for v in ref.values())
    for n, g in ref.items():
        if float(g.abs().max()) <= 1e-6 * top:
            continue
        if n not in grads:
            continue
        a, b = np.asarray(grads[n], np.float64), g.numpy()
        nb = np.linalg.norm(b)
        if nb == 0:
            continue
        out[n] = float(np.linalg.norm(a - b) / nb)
    return out


def main():
    sdf = os.environ.get("SDF", "1") == "1"
    cfg = T.experiment(sdf)
    jmodel, variables = T.full_model_variables(cfg.model, seed=31)
    rng = np.random.RandomState(32)
    batch = {"rgb": rng.randn(T.B, 16, *T.HW, 3).astype(np.float32),
             "salmap": rng.rand(T.B, *T.HW, 1).astype(np.float32),
             "audio": rng.randn(T.B, 9, T.HW[0] // 2, T.HW[1] // 2, 1).astype(np.float32)}
    key = jax.random.PRNGKey(33)
    sched = j_make_schedule()
    k_deq, k_t, k_noise, _ = jax.random.split(key, 4)
    shape = (T.B, *T.HW, 1)
    draws = {"deq": jax.random.normal(k_deq, shape), "noise": jax.random.normal(k_noise, shape),
             "t": jax.random.randint(k_t, (), 0, sched.num_timesteps)}
    branches = T.ReluBranches(pools=False)  # the ReLUs pinned, the pools free
    with torch_pools(POOLS["f64"]):
        ref64 = T.port_f64_step(cfg, variables, batch, draws, branches)
    g64 = ref64["grads"]
    win64 = [w for _, w in POOLS["f64"]]
    print("pools per step (f64):", [x.shape for x, _ in POOLS["f64"]], flush=True)

    # the port's f32 step, winners recorded
    b2 = T.ReluBranches(pools=False)
    b2.masks = list(branches.masks)
    with torch_pools(POOLS["f32"]):
        model, _, _ = T.port_f32_step(cfg, variables, batch, draws, b2)
    port32 = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    # JAX f32 step, winners recorded from its pre-pool values
    jg = jax_step(cfg, jmodel, variables, batch, key, branches, POOLS["jax"])
    print("jax pools recorded:", list(POOLS["jax"]), flush=True)

    for i, (x64, w64) in enumerate(POOLS["f64"]):
        gap = top2_gap(x64)
        w32 = POOLS["f32"][i][1]
        xj = POOLS["jax"].get(x64.shape)
        wj = winners(xj) if xj is not None else None
        d32 = w32 != w64
        line = (f"pool {i} {x64.shape}: windows {w64.size}; port f32 winners differ at "
                f"{int(d32.sum())}, their f64 top-2 gap / max|x| "
                f"{gap[d32].max() if d32.any() else 0:.3e}")
        if wj is not None:
            dj = wj != w64
            line += (f"; JAX f32 winners differ at {int(dj.sum())}, gap "
                     f"{gap[dj].max() if dj.any() else 0:.3e} (max {gap[dj].tolist()[:8]})"
                     f"; |x_jax - x64| / max|x| {np.abs(xj - x64).max() / np.abs(x64).max():.3e}")
        line += f"; smallest f64 gap {gap.min():.3e}"
        print(line, flush=True)

    gj = gaps(jg, g64)
    gp = gaps(port32, g64)
    worst = sorted(gj.items(), key=lambda kv: -kv[1])[:5]
    print("JAX f32 vs port f64, unpinned pools, worst leaves:", worst, flush=True)
    print("port f32 vs port f64, unpinned pools, worst:",
          sorted(gp.items(), key=lambda kv: -kv[1])[:3], flush=True)

    # pinned: every step takes the f64 winners
    jg2 = jax_step(cfg, jmodel, variables, batch, key, branches, {}, pinned=win64)
    gj2 = gaps(jg2, g64)
    print("JAX f32 vs port f64, f64 winners pinned, worst leaves:",
          sorted(gj2.items(), key=lambda kv: -kv[1])[:5], flush=True)
    b3 = T.ReluBranches(pools=False)
    b3.masks = list(branches.masks)
    with torch_pools([], pinned=win64):
        model3, _, _ = T.port_f32_step(cfg, variables, batch, draws, b3)
    gp3 = gaps({n: p.grad for n, p in model3.named_parameters() if p.grad is not None}, g64)
    print("port f32 vs port f64, pinned, worst:",
          sorted(gp3.items(), key=lambda kv: -kv[1])[:3], flush=True)
    print("blocks.8.proj.weight JAX unpinned / pinned:", gj.get("visual_net.blocks.8.proj.weight"),
          gj2.get("visual_net.blocks.8.proj.weight"), "port", gp.get("visual_net.blocks.8.proj.weight"),
          gp3.get("visual_net.blocks.8.proj.weight"), flush=True)
    print("median JAX unpinned / pinned:", np.median(list(gj.values())),
          np.median(list(gj2.values())), flush=True)


if __name__ == "__main__":
    main()
