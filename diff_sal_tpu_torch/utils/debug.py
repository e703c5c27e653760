"""Debugging switches (JAX package `utils/debug.py`; the reference has no
NaN tooling, SURVEY.md §5).

`nan_guard()` turns on autograd's anomaly detection for a scope (the
backward raises at the op that produced a NaN); `check_finite` asserts
that a module's parameters and buffers, or a dict of tensors, hold finite
values; `tree_norms` gives L2 norms per top-level name, for divergence
triage.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Mapping, Tuple, Union

import torch

Tensors = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _named(tree: Tensors) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters()
        yield from tree.named_buffers()
        return
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from ((f"{k}.{n}", t) for n, t in _named(v))
        elif isinstance(v, torch.Tensor):
            yield str(k), v


@contextlib.contextmanager
def nan_guard(enabled: bool = True):
    """autograd anomaly detection (with NaN checks) inside the scope."""
    if not enabled:
        yield
        return
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        yield


def check_finite(tree: Tensors, name: str = "tree") -> None:
    """Raise FloatingPointError naming every tensor with a NaN or an inf."""
    bad = []
    for path, t in _named(tree):
        if not t.is_floating_point():
            continue
        t = t.detach()
        n_nan, n_inf = int(torch.isnan(t).sum()), int(torch.isinf(t).sum())
        if n_nan or n_inf:
            bad.append((path, n_nan, n_inf))
    if bad:
        lines = "\n".join(f"  {p}: nan={n} inf={i}" for p, n, i in bad[:20])
        raise FloatingPointError(f"non-finite values in {name}:\n{lines}")


def tree_norms(tree: Tensors) -> Dict[str, float]:
    """L2 norm per top-level name (the part before the first '.'); of a
    module, over its parameters."""
    sq: Dict[str, torch.Tensor] = {}
    named = tree.named_parameters() if isinstance(tree, torch.nn.Module) else _named(tree)
    for path, t in named:
        if t.is_floating_point():
            top = path.split(".", 1)[0]
            s = t.detach().double().square().sum().cpu()
            sq[top] = sq[top] + s if top in sq else s
    return {k: float(v.sqrt()) for k, v in sq.items()}
