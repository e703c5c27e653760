"""Tensor parallelism on torch.distributed (JAX package `parallel/mesh.py:
81-111`, `tensor_parallel_param_shardings`).

JAX shards a variable leaf over the 'model' axis of its ('data', 'model')
mesh along the leaf's last axis when the leaf has at least two axes and
that axis is at least `min_dim` wide and divides by the model axis; every
other leaf (biases, norms, BatchNorm statistics, rel-pos tables, the cls
token) is replicated. Under `jit` GSPMD partitions the products and
inserts the collectives: the program computes the replicated function.

Here:
* `tensor_parallel_axes` / `tensor_parallel_param_shardings` apply that
  rule to the port's `state_dict` entries, each judged by the shape of its
  flax counterpart, and shard it along the torch axis onto which the
  bridge moves the leaf's last axis (`bridge.flax_layouts`): axis 0, the
  output features, for every Linear, Conv2d, Conv3d and depthwise weight,
  where a torch `Shard(-1)` would split the input features instead.
* `shard_model` keeps, on each rank, its slice of every qualifying
  parameter (and quantised `weight_q` buffer) as a `DTensor` placed
  [Replicate() on 'data', Shard(axis) on 'model']. Every rank builds the
  same full model first, so no data moves.
* The forward computes the replicated function with explicit collectives
  over the model group (the list forms of `all_gather` and `all_reduce`,
  which gloo also takes on CUDA tensors). `models/layers.dense`, `conv2d`
  and `conv3d` call `column_parallel` when their weight is sharded: the
  rank's product on its weight slice and its slice of the replicated
  bias, then a differentiable all-gather of the output channels. In the
  backward the gather hands each rank its slice of the incoming gradient
  and the input's gradient is all-reduced over the model group
  (Megatron's f / g pair, which is what GSPMD computes). A depthwise conv
  (`depthwise_parallel`) convolves the rank's own channels of the input. A
  weight used whole (the operand of a hand-written kernel, the BatchNorm
  fold, a rel-pos table) comes from `full`, a differentiable all-gather;
  no kernel wrapper takes a DTensor (`ops/kernels.refuse_dtensor`).
* Each rank's gradient of a sharded parameter is its slice of the
  replicated gradient; `mesh.average_gradients` over the 'data' group
  averages slices and replicated parameters alike.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

MODEL_AXIS = "model"


def tensor_parallel_axes(model: nn.Module, num_model: int,
                         min_dim: int = 256) -> Dict[str, Optional[int]]:
    """JAX's rule over `model.state_dict()`'s entries: the torch axis each
    entry is sharded along on a model axis of `num_model` ranks, or None
    (replicated). An entry qualifies exactly when its flax counterpart has
    at least two axes and a last axis at least `min_dim` wide that divides
    by `num_model`."""
    from diff_sal_tpu_torch.bridge import flax_layouts

    out: Dict[str, Optional[int]] = {}
    for name, (shape, axis) in flax_layouts(model).items():
        ok = (num_model > 1 and len(shape) >= 2 and shape[-1] >= min_dim
              and shape[-1] % num_model == 0)
        out[name] = axis if ok else None
    return out


def _model_dim(mesh: DeviceMesh) -> int:
    return mesh.mesh_dim_names.index(MODEL_AXIS)


def tensor_parallel_param_shardings(model: nn.Module, mesh: DeviceMesh, min_dim: int = 256
                                    ) -> Dict[str, Tuple[Placement, ...]]:
    """Every `state_dict` entry's placements on `mesh` (one per mesh
    dimension): Shard(axis) on 'model' where `tensor_parallel_axes`
    shards it, Replicate() everywhere else."""
    i = _model_dim(mesh)
    out = {}
    for name, axis in tensor_parallel_axes(model, mesh.size(i), min_dim).items():
        pl = [Replicate()] * mesh.ndim
        if axis is not None:
            pl[i] = Shard(axis)
        out[name] = tuple(pl)
    return out


def shard_model(model: nn.Module, mesh: DeviceMesh, min_dim: int = 256) -> nn.Module:
    """Keep this rank's slice of every entry `tensor_parallel_param_
    shardings` shards, as a DTensor on `mesh` (in place; returns `model`).
    Every rank must hold the same full model: built from one seed, or
    loaded from one `state_dict`. Cast the model (`.double()`, `.to()`)
    before, not after."""
    i = _model_dim(mesh)
    n, r = mesh.size(i), mesh.get_local_rank(i)
    for name, placements in tensor_parallel_param_shardings(model, mesh, min_dim).items():
        shard = placements[i]
        if not isinstance(shard, Shard):
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        t = getattr(mod, leaf)
        local = t.detach().chunk(n, shard.dim)[r].clone(memory_format=torch.contiguous_format)
        dt = DTensor.from_local(local, mesh, placements, run_check=False)
        if isinstance(t, nn.Parameter):
            setattr(mod, leaf, nn.Parameter(dt, requires_grad=t.requires_grad))
        else:
            mod._buffers[leaf] = dt
    return model


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local_bytes(model: nn.Module) -> int:
    """Bytes of the parameters and buffers this rank holds (its slices of
    the sharded entries, the rest whole)."""
    total = 0
    for t in model.state_dict().values():
        t = t.to_local() if is_sharded(t) else t
        total += t.numel() * t.element_size()
    return total


def _layout(t: DTensor):
    """(model group, its size, this rank's index in it, the sharded torch
    axis) of a parameter sharded on 'model'."""
    mesh = t.device_mesh
    i = _model_dim(mesh)
    pl = t.placements[i]
    if not isinstance(pl, Shard):
        raise ValueError(f"a DTensor with placements {t.placements}: only Shard on "
                         f"'{MODEL_AXIS}' is sharded here")
    return mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i), pl.dim


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of `x` along `dim` (the rank's index in `group`)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    s = x.shape[dim] // n
    return x.narrow(dim, r * s, s).clone(memory_format=torch.contiguous_format)


class _Gather(torch.autograd.Function):
    """The ranks' parts concatenated along `dim`; the backward takes this
    rank's part of the gradient (every rank's output feeds the same
    replicated loss)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.dim, ctx.group), None, None


class _Part(torch.autograd.Function):
    """This rank's part of a replicated tensor; the backward gathers the
    ranks' parts of the gradient, so the replicated tensor's gradient is
    whole on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _part(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _Replicated(torch.autograd.Function):
    """The identity on a replicated input of a sharded product; the backward
    sums the ranks' partial gradients over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded parameter, gathered over the model group
    (differentiable: the backward keeps this rank's slice of the gradient);
    any other tensor as it is."""
    if not is_sharded(t):
        return t
    group, _, _, dim = _layout(t)
    return _Gather.apply(t.to_local(), dim, group)


Product = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def column_parallel(x: torch.Tensor, weight: DTensor, bias: Optional[torch.Tensor],
                    product: Product) -> torch.Tensor:
    """`product(x, weight, bias)` (channel-last output) with `weight`
    sharded on its output features (axis 0): this rank's product on its
    slice of the weight and of the replicated `bias`, its output channels
    gathered from every model rank."""
    group, _, _, dim = _layout(weight)
    if dim != 0:
        raise ValueError(f"a product sharded along weight axis {dim}: the output features "
                         "(axis 0) are the ones split")
    x = _Replicated.apply(x, group)
    b = None if bias is None else _Part.apply(bias, 0, group)
    y = product(x, weight.to_local(), b)
    return _Gather.apply(y, y.ndim - 1, group)


def depthwise_parallel(x: torch.Tensor, weight: DTensor, bias: Optional[torch.Tensor],
                       conv: Callable[..., torch.Tensor]) -> torch.Tensor:
    """A depthwise conv (groups = channels) with `weight` sharded on its
    channels: this rank convolves its own channels of the channel-last
    `x` (`conv(x_part, weight_part, bias_part, groups)`), and the channels
    are gathered from every model rank."""
    group, _, _, dim = _layout(weight)
    if dim != 0:
        raise ValueError(f"a depthwise conv sharded along weight axis {dim}")
    w = weight.to_local()
    xs = _Part.apply(x, x.ndim - 1, group)
    b = None if bias is None else _Part.apply(bias, 0, group)
    y = conv(xs, w, b, w.shape[0])
    return _Gather.apply(y, y.ndim - 1, group)
