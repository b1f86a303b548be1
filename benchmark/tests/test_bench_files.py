"""BENCHMARK.json and the files it names: every name and unit obeys the
contract's rules, every file loads by name, and a cell made only of new
files and entries loads and runs."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    cell.check_name(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            cell.check_name(entry[key])
    for key in entry.get("reduced", []):
        cell.check_name(key)
    if "unit" in entry:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_bounds_and_metric_links():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["name"].endswith("_roofline") <= (m["unit"] == "%")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    c = cell.load_cell(name)
    assert c.chips == 1
    assert hasattr(c.driver(), "run") and hasattr(c.check(), "compare")
    assert {m["name"] for m in c.end_to_end} == {"gs_instances_per_min",
                                                 "setup_s"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m).read)
    assert c.config["check"]["limits"]
    assert (ROOT / next(x["file"] for x in BENCH["configs"]
                        if x["name"] == c.config["name"])).is_file()


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_a_cell_of_new_files_only_loads_and_runs(tmp_path):
    """A later PR's cell: a new configuration, traffic mix and per-layer
    metric as files, and entries in BENCHMARK.json; no file changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "chimera512-droplet-fleet8.json")
                     .read_text())
    cfg.update(name="chimera32-tiny")
    cfg["instance"]["cells"] = 2
    cfg["solver"].update(Dmax=16, M=16, dtype="float64")
    cfg["check"]["instances_per_run"] = 1
    (b / "configs" / "chimera32-tiny.json").write_text(json.dumps(cfg))
    traffic = dict(name="gs-tiny", driver="solver_gs", check="gs",
                   params={"path": "host"}, batch=1, pool=3,
                   warmup_cells=2, kernels=["gebal", "marginal"], why="t")
    (b / "traffic" / "gs-tiny.json").write_text(json.dumps(traffic))
    (b / "metrics" / "tiny_units.py").write_text(
        "def read(run):\n    return run.completed\n")
    (b / "metrics" / "tiny_stage_s.py").write_text(
        "def read(run):\n    st = run.stage_times\n"
        "    return st.get('search') if st else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="chimera32-tiny", source="t",
                                 file="benchmark/configs/chimera32-tiny.json",
                                 reduced=["cells"], why="t"))
    bench["workloads"].append(dict(name="c32-tiny", config="chimera32-tiny",
                                   traffic="gs-tiny", chips=1, why="t"))
    bench["end_to_end"].append(dict(name="tiny_units", unit="units",
                                    better="higher", bound=0.25,
                                    source="host_clock",
                                    workloads=["c32-tiny"]))
    bench["per_layer"].append(dict(name="tiny_stage_s", unit="s",
                                   better="lower", source="program_span",
                                   layer="host beam",
                                   moves="gs_instances_per_min",
                                   workloads=["c32-tiny"]))
    c = cell.load_cell("c32-tiny", bench=bench, root=tmp_path)
    assert [m["name"] for m in c.end_to_end] == ["gs_instances_per_min",
                                                 "setup_s", "tiny_units"]
    assert [m["name"] for m in c.per_layer] == ["tiny_stage_s"]
    assert c.reader(c.per_layer[0]).read(run.RunData(
        0.0, 1, 1.0, {"search": 2.0})) == 2.0
    result = run.run_cell(c, 3, 0.01, False, torch.device("cpu"))
    assert result["correct"] and result["failed"] == 0
    assert result["metrics"]["tiny_units"]["value"] == 1   # one unit
    assert list(result)[-1] == "checks"
