"""Process-group set-up (JAX package `parallel/multihost.py`): the
reference's torchrun rendezvous (`init_distributed_mode`,
train_dhf1k.py:38-61) on torch.distributed.

`initialize()` joins the process group from explicit arguments or from
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); with neither it does nothing and the run is one process, as
JAX's does. The backend follows one rule, printed on every rank: `nccl`
where each rank computes on a card of its own, `gloo` where the ranks
compute on the CPU or several of them share a card (NCCL refuses two ranks
on one device). A backend is never switched after a failure. Every
collective has the group's timeout, so a lost rank fails the run instead
of hanging it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def rank_device(local_rank: int, device_type: Optional[str] = None) -> torch.device:
    """The device a rank computes on: the card `local_rank` modulo the
    cards present (ranks share cards when there are more ranks than cards),
    or the CPU where `device_type` is "cpu" or there is no card."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank device was asked for, but torch.cuda.is_available() "
                           "is false")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: Union[str, torch.device], local_world_size: int):
    """(backend, reason): nccl where each of the host's `local_world_size`
    ranks has a card of its own, else gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", "the ranks compute on the CPU"
    cards = torch.cuda.device_count()
    if local_world_size > cards:
        return "gloo", f"{local_world_size} ranks share {cards} card(s)"
    return "nccl", f"{local_world_size} ranks on {cards} card(s), one each"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[torch.device]:
    """Join the process group and return this rank's device, or return None
    (one process: nothing given and no torchrun environment). Arguments
    left None come from torchrun's environment; `init_method` defaults to
    env:// (MASTER_ADDR, MASTER_PORT). `device` is the rank's device
    (default: `rank_device(local_rank)`), which decides the backend."""
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if init_method is None and world_size is None and "MASTER_ADDR" not in os.environ:
        return None
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError("a process group needs its world size and this process's rank "
                         "(arguments, or torchrun's WORLD_SIZE and RANK)")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE") or world_size
    device = torch.device(device) if device is not None else rank_device(local_rank)
    backend, reason = choose_backend(device, local_world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(f"[multihost] rank {rank} of {world_size} on {device}: backend {backend} ({reason})",
          flush=True)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return device


def shutdown():
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def main_print(*args, **kwargs) -> None:
    """Print on rank 0 only (reference setup_for_distributed,
    train_dhf1k.py:22-35)."""
    if is_main_process():
        print(*args, **kwargs)


def process_info() -> dict:
    """JAX's keys: every rank drives one device, so `local_devices` is 1
    and `global_devices` the world size."""
    return {"process_index": process_index(), "process_count": process_count(),
            "local_devices": 1, "global_devices": process_count()}
