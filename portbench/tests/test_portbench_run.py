"""Whole runs on the CPU at a tiny size (`rehearsal.py`): the result line's
keys, the reference against the port, the comparison failing when the
timed path is broken underneath, and the harness importing nothing of
JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.core import spec
from portbench.tests import rehearsal
from portbench.tools import faults

ROOT = Path(__file__).resolve().parents[2]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["av_ddim_b30", "visual_train_b12"])
def test_result_line_has_the_contracts_keys_and_checks_last(cell):
    r = rehearsal.run_cell(cell)
    assert RESULT_KEYS <= set(r) and list(r)[-1] == "checks"
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    names = {m["name"] for m in spec.end_to_end(cell)}
    assert set(r["metrics"]) == names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_carries_per_layer_metrics_and_the_breakdown():
    r = rehearsal.run_cell("av_ddim_b30", trace_on=True)
    allowed = {m["name"] for m in spec.per_layer("av_ddim_b30")}
    assert set(r["metrics"]) <= allowed
    assert r["metrics"]["denoiser_calls.infer"]["value"] == 1.0
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


# the cells, and the paths of the mixes PERF.md keeps for later cells
# (DPM-Solver++, the AV model's step), judged by the nearest cell's limits
INFER_LIMITS = spec.workload("av_ddim_b30")["limits"]
TRAIN_LIMITS = spec.workload("visual_train_b12")["limits"]
TINY_CASES = {
    "av_ddim_b30": "av_ddim_b30",
    "visual_train_b12": "visual_train_b12",
    "av_dpmpp": rehearsal.pair("diffsal_av", "dpmpp2m_nfe5_b30", INFER_LIMITS),
    "av_train": rehearsal.pair("diffsal_av", "train_b12", TRAIN_LIMITS),
}


@pytest.mark.parametrize("case,dtype", [("av_ddim_b30", "float32"), ("av_dpmpp", "float32"),
                                        ("av_train", "float32"), ("av_ddim_b30", "bfloat16")])
def test_reference_matches_the_port_at_a_tiny_size(case, dtype):
    r = rehearsal.run_cell(TINY_CASES[case], dtype)
    c = r["checks"]
    if dtype == "float32":  # two float32 implementations of one function
        own = _reference_rounding_gaps(TINY_CASES[case]) if "grad_gap" in c else {}
        for k, bound in (("map_max_abs", 1e-4), ("map_rel_l2", 1e-5), ("loss_gap", 1e-3),
                         ("grad_gap", 1e-3), ("change_gap", 2e-2)):
            if k in c:
                # a step that one rounding of its input moves by more than
                # the bound is held to twice that movement instead
                assert c[k]["value"] < max(bound, 2 * own.get(k, 0.0)), (k, c[k], own)
    assert r["correct"] is True


def _reference_rounding_gaps(cell) -> dict:
    """The training numbers of the reference against itself with its clips
    scaled by 1 + 1e-7, one float32 rounding, at the rehearsal's size:
    how far rounding alone moves the step (the audio-visual step over all
    9 frames reads ~1.4e-3 on the worst leaf's gradient, as far as the
    port does)."""
    from portbench.core import check, data

    cell = spec.workload(cell) if isinstance(cell, str) else cell
    cfg = rehearsal.tiny(spec.config(cell["config"]), "float32")["model"]
    traffic = dict(spec.traffic(cell["traffic"]), batch=2)
    seed = 2 ** 31 + 12345  # the rehearsal's seed
    batches = data.draw_batches(cfg, traffic, seed, "cpu")
    moved = [dict(b, rgb=b["rgb"] * (1 + 1e-7)) for b in batches]
    ref = check.reference_steps(cfg, traffic, seed, "cpu", batches)
    again = check.reference_steps(cfg, traffic, seed, "cpu", moved)
    return check.step_numbers(*again, *ref)[0]


INFER_FAULTS = ("answer_altered", "half_batch_infer", "state_unchanged_infer")
TRAIN_FAULTS = ("state_unchanged_train", "half_batch_train", "answer_altered_train")


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in [w["name"] for w in spec.benchmark()["workloads"]]
    for fault in (INFER_FAULTS if spec.traffic(spec.workload(cell)["traffic"])["kind"] == "infer"
                  else TRAIN_FAULTS)])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault):
    with faults.planted(fault):
        r = rehearsal.run_cell(cell)
    assert r["correct"] is False, r["checks"]


SOURCE_MODULES = ("portbench.run", "portbench.core.session", "portbench.core.port",
                  "portbench.core.check", "portbench.core.trace", "portbench.core.flops",
                  "portbench.reference.model", "portbench.reference.diffusion")


def test_nothing_the_harness_or_the_reference_imports_is_jax():
    """Top-level names compared whole: `diff_sal_tpu_torch` is not
    `diff_sal_tpu`. The port is imported the way a run does (its model,
    sampler and step)."""
    code = (
        "import sys, importlib\n"
        f"for m in {SOURCE_MODULES!r}: importlib.import_module(m)\n"
        "from portbench.core import port, spec\n"
        "cfg = spec.config('diffsal_av')['model']\n"
        "port.model_config(cfg)\n"
        "import diff_sal_tpu_torch.inference, diff_sal_tpu_torch.train.train_step\n"
        "import diff_sal_tpu_torch.train.optim, diff_sal_tpu_torch.ops.kernels\n"
        "from portbench.run import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "diff_sal_tpu" not in text and "import jax" not in text, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "diff_sal_tpu_torch_extra", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert forbidden_modules() == ["jax"]


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "av_ddim_b30",
                          "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_whose_chips_its_traffic_kind_does_not_launch_is_refused(monkeypatch, capsys):
    """A cell asking for 4 chips of a kind that launches one: no result,
    exit 1, before anything looks for a card."""
    from portbench import run as run_mod

    assert spec.kind("infer").CHIPS == (1,) and spec.kind("train").CHIPS == (1,)
    real = spec.workload
    monkeypatch.setattr(spec, "workload", lambda name: dict(real(name), chips=4))
    assert run_mod.main(["--workload", "av_ddim_b30", "--seed", "1", "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "launches (1,)" in out.err
