"""The port's profiling (tnax_torch.profiling: trace, phase) and its
"tnax_torch" logger at tnax's log points, on the CPU."""

import json
import logging
import os

import pytest
import torch

import tnax_torch as tt
from tnax_torch import profiling

from torch_helpers import degenerate_J


def _solver():
    return tt.Solver(mode="Ising", Nx=3, Ny=3, Nc=2, beta=1.5,
                     J=degenerate_J(), device="cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64, dtype=torch.float64)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        assert prof is not None
        (a @ a).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_trace_is_off_without_a_directory():
    with profiling.trace(None) as prof:
        assert prof is None


def test_phase_sums_into_its_sink_and_logs(caplog):
    sink = {}
    with caplog.at_level(logging.INFO, logger="tnax_torch"):
        for _ in range(2):
            with profiling.phase("boundary", sink):
                torch.ones(8).sum()
        with profiling.phase("search"):
            pass
    assert set(sink) == {"boundary"} and sink["boundary"] >= 0.0
    lines = [r.getMessage() for r in caplog.records]
    assert sum(m.startswith("phase boundary: ") for m in lines) == 2
    assert any(m.startswith("phase search: ") for m in lines)


def test_host_search_logs_each_row(caplog):
    ins = _solver()
    assert ins.logger is logging.getLogger("tnax_torch")
    with caplog.at_level(logging.INFO, logger="tnax_torch"):
        ins.search_ground_state(M=16, Dmax=8, path="host")
    lines = [r.getMessage() for r in caplog.records
             if r.name == "tnax_torch"]
    rows = [m for m in lines if m.startswith("Row ")]
    assert [m.split(":")[0] for m in rows] == ["Row 1/3", "Row 2/3",
                                               "Row 3/3"]
    assert all(" branches, " in m for m in rows)
    assert lines[0] == "Preprocessing boundary MPS (D=8) ..."
    assert lines[-1].startswith("Search total: ")


@pytest.mark.parametrize("path", ["host", "device"])
def test_spectrum_and_sampling_log_their_rows(caplog, path):
    ins = _solver()
    with caplog.at_level(logging.INFO, logger="tnax_torch"):
        ins.search_low_energy_spectrum(M=16, Dmax=8, max_dEng=1.0,
                                       path=path)
        ins.gibbs_sampling(M=8, Dmax=8, seed=3)
    lines = [r.getMessage() for r in caplog.records]
    word = "Row 3/3: " if path == "host" else "Row 3/3 replayed: "
    assert sum(m.startswith(word) for m in lines) == 1
    assert any(m.startswith("Sampling total: ") for m in lines)
