"""On the card: the control of each cell's comparison comes out not
correct at the cell's own size, and the program on the same instances
correct. Run there with

    python -m pytest -p no:cacheprovider -m gpu \
        benchmark/tests/test_bench_gpu.py
"""

import json
import sys
from pathlib import Path

import pytest

from benchmark import control
from benchmark.harness import cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    import torch
    c = cell.load_cell(name)
    got = {side: numbers for side, _, numbers in control.readings(
        c, 2 ** 31 + 17, torch, card,
        log=lambda m: print(m, file=sys.stderr))}
    assert c.check().passed(got["program"]), got["program"]
    assert not c.check().passed(got["control"]), got["control"]
