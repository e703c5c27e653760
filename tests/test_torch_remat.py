"""`MViTConfig.remat` (each MViT block recomputed in the backward pass,
`torch.utils.checkpoint`; JAX `nn.remat`, mvit.py:1550) on the CPU, tiny
MViT at 32x48, both layouts.

The loss is the pyramid against fixed random weights, sum_s <y_s, w_s>, so
every block and every emitted scale is on the graph. The port with
`remat` on against off: the same forward, so the same loss bit for bit,
and gradients equal to f32 rounding (the recompute saves the same tensors;
only the order in which autograd adds a parameter's two uses, the spatial
and the cls rows, may differ). The port with `remat` on against JAX's
MViT with `remat=True`: the gradient bound of tests/test_torch_train_step.py
(`assert_gradient_leaves_match`: each f32 side within its own rounding of
the port's f64 step, the two within 4x the larger). MViT has no ReLU; its
strided skip max pools are pinned to the f64 step's winners (F6,
`ReluBranches`): the recompute runs each pool again, in reverse block
order, so the port's remat run takes the recorded winners twice.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.models.mvit import MViT as JMViT
from diff_sal_tpu_torch import bridge
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.models.mvit import MViT
from test_torch_models import random_variables
from test_torch_train_step import ReluBranches, assert_gradient_leaves_match, one_torch_thread

HW = (32, 48)


def _setup(cls_stream: bool):
    cfg = jc.MViTConfig.tiny(spatial_size=HW, cls_stream=cls_stream, remat=True)
    rng = np.random.RandomState(31)
    x = rng.randn(2, 16, *HW, 3).astype(np.float32)
    jm = JMViT(cfg)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 32)
    shapes = [o.shape for o in jax.eval_shape(jm.apply, variables, x)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    return cfg, jm, variables, x, ws


def _port_step(cfg, variables, x, ws, remat: bool, dtype=torch.float32, pinned=None):
    """The port's loss and gradients (by parameter name) with `remat`."""
    m = MViT(dataclasses.replace(pc.from_fields(cfg), remat=remat)).train()
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                       bridge.export_mvit(variables["params"], cfg.num_layers).items()},
                      strict=True)
    m.to(dtype)
    with one_torch_thread(), (pinned or contextlib.nullcontext()):
        outs = m(torch.from_numpy(x).to(dtype))
        loss = sum((o * torch.from_numpy(w).to(dtype)).sum() for o, w in zip(outs, ws))
        loss.backward()
    return m, float(loss), {n: p.grad for n, p in m.named_parameters()}


@pytest.fixture(scope="module", params=[True, False], ids=["cls_stream", "token_concat"])
def steps(request):
    cfg, jm, variables, x, ws = _setup(request.param)
    # the f64 step without remat records each pool's winners once
    branches = ReluBranches()
    with branches.recording():
        _, loss64, grads64 = _port_step(cfg, variables, x, ws, remat=False,
                                        dtype=torch.float64)
    off = _port_step(cfg, variables, x, ws, remat=False)
    on = _port_step(cfg, variables, x, ws, remat=True)
    # the remat run pools each strided block again in the backward, last
    # block first (one strided pool per block)
    twice = ReluBranches()
    twice.pools = list(branches.pools) + list(branches.pools[::-1])
    pinned = _port_step(cfg, variables, x, ws, remat=True, pinned=twice.pinned_torch())

    def loss(params):
        outs = jm.apply({"params": params}, x)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    with ReluBranches.pinned_jax(branches):
        jgrads = jax.jit(jax.grad(loss))(variables["params"])
    jax_grads = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 bridge.export_mvit(jax.device_get(jgrads), cfg.num_layers).items()}
    return {"off": off, "on": on, "pinned": pinned, "grads64": grads64, "jax": jax_grads,
            "flips": twice.flips, "loss64": loss64, "pools": len(branches.pools)}


def test_remat_step_equals_the_plain_step(steps):
    (_, loss_off, g_off), (_, loss_on, g_on) = steps["off"], steps["on"]
    assert loss_on == loss_off
    assert abs(loss_on - steps["loss64"]) <= 1e-5 * abs(steps["loss64"])
    top = max(float(g.abs().max()) for g in g_off.values())
    n = 0
    for name, g in g_off.items():
        assert g is not None and g_on[name] is not None, name
        d = float((g_on[name] - g).abs().max())
        # f32 rounding of a sum in another order
        assert d <= 1e-6 * top, (name, d, top)
        n += 1
    assert n > 150


def test_remat_step_matches_jax_remat(steps):
    model, _, _ = steps["pinned"]
    assert steps["pools"] == 3  # blocks 1, 3 and 8 pool their skip
    worst = assert_gradient_leaves_match(steps["jax"], model, steps["grads64"], min_leaves=150)
    print(f"pool winners taken other than the f32 run's own: {steps['flips']}; worst {worst}")


@pytest.mark.parametrize("cls_stream", [True, False])
def test_remat_launches_mvit_forward_kernels_again(monkeypatch, cls_stream):
    """Launch routing with every wrapper's CPU path counted: a remat step
    runs each block's attention and LayerNorms twice (forward, recompute),
    the emitted scales' norms once; the backward kernels as often as
    without remat. Under no_grad remat changes nothing."""
    from diff_sal_tpu_torch.ops import attention, layernorm

    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    fwd = "bias_attention_fwd" if cls_stream else "fused_bias_attention_fwd"
    for mod, name in ((attention, fwd), (attention, fwd.replace("fwd", "bwd")),
                      (layernorm, "layer_norm_fwd"), (layernorm, "layer_norm_bwd")):
        counted(mod, name)
    cfg = pc.MViTConfig.tiny(spatial_size=HW, cls_stream=cls_stream)
    x = torch.randn(1, 16, *HW, 3, generator=torch.Generator().manual_seed(3))
    seen = {}
    for remat in (False, True):
        m = MViT(dataclasses.replace(cfg, remat=remat)).train()
        torch.manual_seed(0)
        for p in m.parameters():
            p.data.normal_(0, 0.05)
        calls.clear()
        with torch.no_grad():
            m(x)
        seen[(remat, "no_grad")] = dict(calls)
        calls.clear()
        sum(o.sum() for o in m(x)).backward()
        seen[(remat, "grad")] = dict(calls)
    L, S = cfg.num_layers, len(cfg.out_scales)
    assert seen[(True, "no_grad")] == seen[(False, "no_grad")] == {
        fwd: L, "layer_norm_fwd": 7 * L + S}
    bwd = seen[(False, "grad")]
    assert bwd[fwd] == L and bwd["layer_norm_fwd"] == 7 * L + S
    assert seen[(True, "grad")] == {**bwd, fwd: 2 * L, "layer_norm_fwd": 14 * L + S}
