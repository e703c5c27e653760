"""BENCHMARK.json against the contract it is checked by, and every name in
it against the file the harness finds it by."""

import json
import re
from pathlib import Path

import pytest

from portbench.core import port, spec
from portbench.reference import model as ref_model

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

B = spec.benchmark()
METRICS = B["end_to_end"] + B["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_size():
    assert set(B) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert B["paths"] == ["portbench"] and B["command"] == ["python3", "portbench/run.py"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
             + [w["config"] for w in B["workloads"]] + [w["traffic"] for w in B["workloads"]]
             + [m["name"] for m in METRICS] + [k for c in B["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for group in (B["configs"], B["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for text in ([c["source"] for c in B["configs"]] + [w["why"] for w in B["workloads"]]
                 + [c["why"] for c in B["configs"]] + [m["layer"] for m in B["per_layer"]]):
        assert _line(text), text


def test_entries_have_just_the_contract_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in B["workloads"]:
        e2e = [m["name"] for m in spec.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.per_layer(w["name"]), w["name"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in B["end_to_end"])


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in spec.end_to_end(cell)], (m["name"], cell)


def test_metrics_of_one_layer_name_it_alike_and_rooflines_are_named_so():
    layers = {m["layer"] for m in B["per_layer"]}
    assert layers == {"entry", "sampler", "networks", "kernels", "device"}
    for m in B["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cells_configs_traffic_and_readers_are_found_by_name(cell):
    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    kind = spec.kind(traffic["kind"])
    assert callable(kind.run) and w["chips"] in kind.CHIPS
    assert len(w["why"]) <= 200
    for m in spec.per_layer(cell):
        reader = spec.reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
    compared = ({"map_max_abs", "map_rel_l2"} if traffic["kind"] == "infer"
                else {"loss_gap", "loss1_gap", "grad_gap", "grad_gap_median", "change_gap",
                      "change_gap_median"})
    assert set(w["limits"]) <= compared and w["limits"]
    assert cfg["name"] == w["config"]


@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_config_files_build_the_port_and_the_reference_alike(config):
    c = {x["name"]: x for x in B["configs"]}[config]
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
    # the published graph: exact GELU, every decoder stage over all 9 frames
    m = body["model"]
    assert m["visual"]["gelu"] == m["decoder"]["gelu"] == "exact"
    assert not m["decoder"]["skip_dead_frames_all"] and not m["decoder"]["skip_dead_frames_train"]
    assert c["file"].startswith("portbench/configs/")
    port_cfg = port.model_config(body["model"])
    assert port_cfg.compute_dtype == "bfloat16" and port_cfg.visual.num_layers == 16
    ref = ref_model.build(body["model"], "meta")
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel
    import torch

    with torch.device("meta"):
        prog = VideoSaliencyModel(port_cfg)
    assert {k: tuple(v.shape) for k, v in prog.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}


def test_every_config_has_a_cell_and_every_reader_a_metric():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    files = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert files == {m["name"] for m in B["per_layer"]}
    cells = {p.stem for p in (spec.BENCH_DIR / "workloads").glob("*.json")}
    assert {w["name"] for w in B["workloads"]} <= cells
    kinds = {p.stem for p in (spec.BENCH_DIR / "kinds").glob("*.py")}
    used = {spec.traffic(w["traffic"])["kind"] for w in B["workloads"]}
    assert used <= kinds
