"""The data-parallel layout on torch.distributed (JAX package
`parallel/mesh.py`).

The reference's only parallelism is data parallelism over NCCL DDP
(train_dhf1k.py:38-61, model.py:13-15). JAX runs it as one SPMD program
over a ('data', 'model') mesh, the batch sharded on 'data'. Here the
"mesh" is the process group of the data ranks (world x 1): every rank
holds the whole model and steps on its rows of the global batch.

* Rows: rank r of W takes rows r::W of a global batch (`shard_batch`).
  That is the loader's rule (`data/loader.py`: process p iterates
  `indices[p::n]`), so the union of the ranks' k-th batches is the
  single-process k-th batch.
* `all_reduce_sum` is a differentiable all-reduce: its backward
  all-reduces the incoming gradient. The decoder's BatchNorms sum their
  statistics through it, so that they normalise over the global batch as
  JAX's one program does (`models/layers.BatchNorm`).
* `average_gradients` is the gradient all-reduce, one flat buffer per
  dtype between `backward()` and the optimizer's clip and Adam.
* `reduce_means` / `reduce_weighted` turn per-rank metrics into the global
  batch's and the whole set's, as JAX's jitted reductions over the
  sharded batch give them (the reference logs rank 0's shard only,
  diffusion_trainer.py:684,746).

JAX's `make_mesh_for_batch` shrinks the mesh to gcd(batch, devices) with a
warning; a torch rank cannot sit out a step, so here an indivisible batch
raises.

The ('data', 'model') mesh of tensor parallelism is `make_device_mesh`, a
`DeviceMesh` whose 'data' group plays the part of `make_mesh`'s group
(`shard_batch`, `average_gradients`, the BatchNorm statistics) and whose
'model' group the sharded weights live on (`parallel/tensor.py`). JAX's
`make_mesh` takes the first num_data x num_model devices; here the mesh
must cover every rank, since a torch rank cannot sit out.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from diff_sal_tpu_torch.parallel.tensor import is_sharded

Group = Optional[dist.ProcessGroup]


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def make_mesh(num_data: int = -1, num_model: int = 1, group: Group = None) -> Group:
    """The data ranks' process group: `group`, or the default group where
    the process group is initialized; None in one process without one.
    `num_data` is -1 (every rank) or the world size: a rank cannot sit a
    step out. A model axis wider than 1 is `make_device_mesh`'s."""
    if num_model != 1:
        raise ValueError(f"num_model={num_model}: make_mesh returns the data ranks' group; "
                         "the ('data', 'model') mesh is make_device_mesh(num_data, num_model)")
    if group is None and not dist.is_initialized():
        if num_data not in (-1, 1):
            raise ValueError(f"num_data={num_data} without a process group: one process")
        return None
    group = group if group is not None else dist.group.WORLD
    w = dist.get_world_size(group)
    if num_data not in (-1, w):
        raise ValueError(f"num_data={num_data}, but the process group has {w} ranks; every "
                         "rank takes part in every step")
    return group


def make_mesh_for_batch(batch_size: int, num_model: int = 1, group: Group = None) -> Group:
    """`make_mesh()`, after checking that the global batch divides by the
    number of ranks (JAX shrinks its mesh to the gcd instead)."""
    group = make_mesh(-1, num_model, group)
    w = world_size(group)
    if batch_size % w:
        raise ValueError(f"batch_size={batch_size} does not divide over {w} data-parallel "
                         f"ranks; pick a multiple of {w}")
    return group


def make_device_mesh(num_data: int = -1, num_model: int = 1,
                     device_type: Optional[str] = None):
    """The ('data', 'model') mesh over every rank of the initialized process
    group (JAX `make_mesh`): rank r sits at (r // num_model, r % num_model),
    JAX's `reshape(num_data, num_model)` of its device list; `num_data=-1`
    means world / num_model. Raises where num_data x num_model is not the
    world size. `device_type` is "cuda" unless the caller asks for "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError("make_device_mesh needs the process group (multihost.initialize)")
    world = dist.get_world_size()
    if num_model < 1 or world % num_model:
        raise ValueError(f"num_model={num_model} does not divide the {world} ranks")
    if num_data == -1:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"a {num_data} x {num_model} mesh over {world} ranks: the mesh must "
                         "cover every rank (a torch rank cannot sit out)")
    return DeviceMesh(device_type or "cuda",
                      torch.arange(world).reshape(num_data, num_model),
                      mesh_dim_names=("data", "model"))


def shard_batch(batch: Mapping, group: Group) -> Dict:
    """This rank's rows r::W of every field of a global batch (tensors,
    arrays and lists alike)."""
    w, r = world_size(group), rank(group)
    return dict(batch) if w == 1 else {k: v[r::w] for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the incoming gradient
    over them likewise (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The differentiable all-reduce (sum) of `x` over `group`."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], group: Group):
    """Replace every parameter's gradient by its mean over the ranks: one
    flat all-reduce per dtype, summed and then divided by W. The ranks hold
    the same model, so the same parameters have gradients on each. A
    sharded parameter's gradient (a DTensor, `parallel/tensor.py`) is
    averaged in place as this rank's slice, so `group` is the 'data' group
    of the mesh there."""
    w = world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            g = p.grad.to_local() if is_sharded(p.grad) else p.grad
            by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(w)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def reduce_device(group: Group, device) -> torch.device:
    """Where small host-side reductions run: the card under NCCL, which
    takes no CPU tensors; the CPU under gloo."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device(device)
    return torch.device("cpu")


@torch.no_grad()
def reduce_means(metrics: List[Mapping[str, torch.Tensor]], group: Group,
                 device) -> List[Dict[str, float]]:
    """Each step's metrics (0-d tensors, one dict per step, the same keys
    on every rank) averaged over the ranks: the global batch's values,
    since every rank steps on as many rows. One all-reduce for the list."""
    if not metrics:
        return []
    keys = list(metrics[0])
    dev = reduce_device(group, device)
    table = torch.stack([torch.stack([m[k].detach().to(dev, torch.float64) for k in keys])
                         for m in metrics])
    dist.all_reduce(table, group=group)
    table = (table / world_size(group)).cpu().numpy()
    return [dict(zip(keys, map(float, row))) for row in table]


@torch.no_grad()
def reduce_weighted(sums: Mapping[str, float], count: float, group: Group,
                    device) -> Dict[str, float]:
    """sum_ranks(sums[k]) / sum_ranks(count) for every k: weighted scores
    (Σ score·n, Σ n) over the whole set, in f64."""
    keys = list(sums)
    dev = reduce_device(group, device)
    v = torch.tensor([sums[k] for k in keys] + [count], dtype=torch.float64, device=dev)
    dist.all_reduce(v, group=group)
    v = v.cpu().numpy()
    total = max(float(v[-1]), 1.0)
    return {k: float(x) / total for k, x in zip(keys, v[:-1])}


def broadcast_object(obj, group: Group, src: int = 0):
    """Rank `src`'s Python object on every rank."""
    if world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group: Group, device=None):
    if world_size(group) > 1:
        if dist.get_backend(group) == "nccl" and device is not None:
            dist.barrier(group=group, device_ids=[torch.device(device).index or 0])
        else:
            dist.barrier(group=group)


def rank_seed(seed: int, epoch: int, rank_index: int) -> int:
    """A 63-bit seed of (seed, epoch, rank), apart from the shared
    (seed, epoch) stream: each rank's dropout and DropPath masks."""
    ss = np.random.SeedSequence([seed, epoch], spawn_key=(rank_index,))
    return int(ss.generate_state(1, np.uint64)[0] >> 1)
