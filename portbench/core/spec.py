"""What a run reads from its files: `BENCHMARK.json` at the checkout's
root, and under `portbench/` a cell's `workloads/<name>.json`, its
configuration's `configs/<name>.json`, its traffic's `traffic/<name>.json`,
the loop of that traffic's kind `kinds/<kind>.py` and each per-layer
metric's reader `metrics/<name>.py`. Everything is found by the name
that `BENCHMARK.json` (or the traffic file, for its kind) gives it."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """A cell's file, with its entry in BENCHMARK.json, which it has to
    agree with."""
    spec = _json(BENCH_DIR / "workloads" / f"{name}.json")
    entry = {w["name"]: w for w in benchmark()["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {spec[key]!r} != BENCHMARK.json's "
                             f"{entry[key]!r}")
    return dict(spec, name=name)


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def end_to_end(cell: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in benchmark()["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(cell: str) -> List[dict]:
    return [m for m in benchmark()["per_layer"] if cell in m.get("workloads", [cell])]


def _module(folder: str, name: str) -> ModuleType:
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench/{folder}/{name}.py does not exist")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> ModuleType:
    """metrics/<name>.py, which defines UNIT and read(ctx) -> number or None."""
    return _module("metrics", name)


def kind(name: str) -> ModuleType:
    """kinds/<name>.py, the loop of a traffic kind: CHIPS, the chip counts
    it launches, and run(cfg, traffic, seed, seconds, traced, t_start)."""
    return _module("kinds", name)


def subseed(seed: int, tag: str) -> int:
    """A 62-bit seed of its own for each stream a run draws from."""
    return int(hashlib.sha256(f"{seed}/{tag}".encode()).hexdigest()[:15], 16)
