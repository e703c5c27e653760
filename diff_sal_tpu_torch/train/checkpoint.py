"""Checkpoints: one torch file per epoch and the best-checkpoint pointer
(JAX package `train/checkpoint.py`, which writes orbax checkpoints).

Each file is the reference's own contract, `torch.save({"state_dict",
"optim_dict", "epoch", "step"})` (diffusion_trainer.py:263-280, 408-428):
`state_dict` is the model's, under the reference's torch names with its
buffers (BatchNorm statistics); `optim_dict` holds Adam's moments by
parameter name, the update count and the EMA shadow (None when off).
Files are `<directory>/<step>.pth`, written to a temporary name and then
renamed, so that a crash never leaves half a checkpoint under a step's
name. `best.json` ({"step", "score"}) points at the checkpoint with the
highest validation nss+cc+sim (reference :276-280). With `max_to_keep`,
the oldest files go once more are kept, except the one `best.json` names.

`partial_load` is the strict=0 warm start (reference model.py:17-22):
the entries of a source state_dict whose name and shape match.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_file = os.path.join(self.directory, "best.json")

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pth")

    def all_steps(self) -> List[int]:
        pat = re.compile(r"^(\d+)\.pth$")
        return sorted(int(m.group(1)) for m in map(pat.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Mapping[str, Any]):
        tmp = self.path(step) + ".tmp"
        torch.save(dict(state), tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep is not None:
            best = self.best()
            keep = set(self.all_steps()[-self.max_to_keep:])
            if best is not None:
                keep.add(best["step"])
            for s in self.all_steps():
                if s not in keep:
                    os.remove(self.path(s))

    def restore(self, step: Optional[int] = None, map_location=None) -> Optional[Dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- best-model bookkeeping (max nss+cc+sim, reference :276-280) --------
    def update_best(self, step: int, score: float) -> bool:
        best = self.best()
        if best is None or score > best["score"]:
            with open(self._best_file, "w") as f:
                json.dump({"step": int(step), "score": float(score)}, f)
            return True
        return False

    def best(self) -> Optional[dict]:
        if not os.path.exists(self._best_file):
            return None
        with open(self._best_file) as f:
            return json.load(f)

    def restore_best(self, map_location=None) -> Optional[Dict]:
        b = self.best()
        if b is None:
            return None
        return self.restore(b["step"], map_location)


def partial_load(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """strict=0 warm start: for each entry of `target`, the source's entry
    of the same name where its shape matches, else the target's own.
    Returns (merged, n_loaded, n_skipped)."""
    merged, loaded, skipped = {}, 0, 0
    for name, t in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(t.shape):
            merged[name] = src
            loaded += 1
        else:
            merged[name] = t
            skipped += 1
    return merged, loaded, skipped
