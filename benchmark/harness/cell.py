"""A cell of ``BENCHMARK.json`` and everything it names, found by name.

- a configuration: the JSON file its entry in ``configs`` names;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, naming its driver
  (``benchmark/drivers/<driver>.py``) and its comparison
  (``benchmark/checks/<check>.py``);
- a metric: ``benchmark/metrics/<name>.py``, a ``read(run)`` function.

Adding a cell, a configuration, a traffic mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name):
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad name {name!r}: 1-64 letters, digits, '_', "
                         f"'.', '-', not starting with '.' or '-'")
    return name


def load_module(kind, name, bench_dir=BENCH):
    """The module ``<bench_dir>/<kind>/<name>.py`` (names may hold
    dots)."""
    path = Path(bench_dir) / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{re.sub('[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the benchmark's metric entries this cell reports
    per_layer: list
    bench_dir: Path = BENCH

    def driver(self):
        return load_module("drivers", self.traffic["driver"], self.bench_dir)

    def check(self):
        return load_module("checks", self.traffic["check"], self.bench_dir)

    def reader(self, metric):
        return load_module("metrics", metric["name"], self.bench_dir)


def _reports(metric, cell, e2e_names):
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(workload, bench=None, root=ROOT):
    """The :class:`Cell` named ``workload`` (ValueError if there is
    none) of the benchmark ``bench`` (by default ``root``'s
    ``BENCHMARK.json``), whose files lie under ``root/benchmark``."""
    bench_dir = Path(root) / BENCH.name
    bench = bench or load_json(Path(root) / "BENCHMARK.json")
    cells = {check_name(w["name"]): w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(Path(root) / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic"
                        / f"{check_name(w['traffic'])}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                bench_dir)
