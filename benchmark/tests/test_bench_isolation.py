"""What a run may load and where it refuses to run: no module whose
top-level name is jax, jaxlib, flax or tnax; the reference imports nothing
of the program; no result without a card, or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "tnax"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules({"tnax_torch": 1, "tnax_torch.search": 1,
                                  "jaxtyping": 1, "numpy": 1}) == []
    assert run.forbidden_modules({"tnax": 1, "tnax.search": 1,
                                  "jax.numpy": 1, "flax": 1}) == [
        "flax", "jax.numpy", "tnax", "tnax.search"]


def test_no_source_imports_jax_or_tnax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"tnax_torch"}), path


def test_a_dry_import_of_the_harness_loads_no_jax():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark import run, control\n"
        "from benchmark.harness import cell\n"
        "for w in json.load(open(%r))['workloads']:\n"
        "    c = cell.load_cell(w['name'])\n"
        "    c.driver(); c.check()\n"
        "    [c.reader(m) for m in c.end_to_end + c.per_layer]\n"
        "import tnax_torch\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    ) % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _bench(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300)


def test_a_measurement_without_a_card_fails():
    out = _bench(["--workload", "c2048-gs-device", "--seed", "1",
                  "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, '.');"
            "from benchmark import run;"
            "from benchmark.harness import cell;"
            "c = cell.load_cell('c2048-gs-device', root='.');"
            "print(run.run_cell(c, 1, 1, False, torch.device('cpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "tnax_torch" in out.stderr
    assert out.stdout.strip() == ""
