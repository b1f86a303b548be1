"""The readers of the program's own spans and counters (the ladder's
sub-spans, the variational passes, the host's waits, the ladder's kernels)
on hand-written stage times and traces, and on a CPU run of
``benchmark/drivers/solver_gs.py`` at chimera-32."""

import functools
import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import trace
from benchmark.harness.cell import load_module

ROOT = Path(__file__).resolve().parents[2]
NEW = ["ladder_build_s_per_instance", "ladder_balance_s_per_instance",
       "variational_s_per_instance.ladder",
       "variational_s_per_instance.boundary", "passes_per_row.ladder",
       "passes_per_row.boundary", "dispatch_s_per_instance.ladder",
       "kernels_per_instance.ladder"]
STAGE_READERS = NEW[:-1]

# two rungs of one instance, then the boundary and the search
STAGE_TIMES = {
    "ladder/peps": 0.5, "ladder/peps#wait_s": 0.25,
    "ladder/build": 6.0, "ladder/build#rows": 8, "ladder/build#passes": 40,
    "ladder/build#variational_s": 4.0, "ladder/build#wait_s": 1.5,
    "ladder/balance": 2.0, "ladder/balance#wait_s": 0.25,
    "ladder": 9.0, "ladder#wait_s": 0.5,
    "boundary": 3.0, "boundary#rows": 4, "boundary#passes": 6,
    "boundary#variational_s": 1.0, "boundary#wait_s": 0.5,
    "search": 1.0, "search#wait_s": 0.75,
    "ud builds#passes": 99, "ud builds#rows": 1}


def reader(name):
    return load_module("metrics", name)


def stage_run(stage_times, completed=2, trace_data=None):
    return run.RunData(10.0, completed, 30.0, stage_times, trace_data)


def test_new_metrics_are_entries_with_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["c2048-gs-device", "c512x8-gs-fleet"]
        assert m["moves"] == "gs_instances_per_min"
        assert m["better"] == "lower"
        assert callable(reader(name).read)
    assert [m["name"] for m in bench["per_layer"]][-len(NEW):] == NEW


@pytest.mark.parametrize("name, value", [
    ("ladder_build_s_per_instance", 3.0),
    ("ladder_balance_s_per_instance", 1.0),
    ("variational_s_per_instance.ladder", 2.0),
    ("variational_s_per_instance.boundary", 0.5),
    ("passes_per_row.ladder", 5.0),
    ("passes_per_row.boundary", 1.5),
    # 9 s of ladder less 2.5 s of waits, over two instances
    ("dispatch_s_per_instance.ladder", 3.25)])
def test_stage_readers_by_hand(name, value):
    assert reader(name).read(stage_run(dict(STAGE_TIMES))) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", STAGE_READERS)
@pytest.mark.parametrize("stage_times", [
    None, {},
    # the parent program: stages without sub-spans or counters
    {"ladder": 9.0, "peps": 0.1, "boundary": 3.0, "search": 1.0},
    # the host path: no device ladder, no boundary counters
    {"ud builds": 2.0, "ud sweeps": 1.0, "boundary": 3.0, "search": 9.0}],
    ids=["untraced", "empty", "parent", "host"])
def test_stage_readers_read_nothing_where_the_keys_are_absent(
        name, stage_times):
    assert reader(name).read(stage_run(stage_times)) is None


def test_stage_readers_read_nothing_without_completed_instances():
    for name in ("ladder_build_s_per_instance",
                 "variational_s_per_instance.ladder",
                 "dispatch_s_per_instance.ladder"):
        assert reader(name).read(stage_run(dict(STAGE_TIMES), 0)) is None


def kernels_run(spans, events, instances=2):
    data = trace.TraceData(instances=instances, events=events,
                           window_s=10.0,
                           kernel_bounds_s={"k2": [], "k3": []},
                           spans=spans)
    return stage_run(None, instances, data)


def test_ladder_kernels_by_interval():
    spans = [("ladder/peps", 0.0, 1.0), ("ladder/peps#wait_s", 1.0, 1.0),
             ("ladder/build", 1.0, 4.0), ("ladder/build#rows", 4.0, 4.1),
             ("ladder/balance", 4.1, 5.0), ("ladder", 5.0, 5.5),
             ("boundary", 5.5, 8.0), ("search", 8.0, 9.0)]
    ev = trace.DeviceEvent
    events = [ev("k", 0.0, 0.1),              # the first span's start
              ev("k", 0.9, 1.2),              # starts in peps
              ev("k", 4.05, 4.06),            # in a counter's interval
              ev("Memcpy HtoD", 2.0, 2.1),    # a copy: not a kernel
              ev("Memset (Device)", 4.5, 4.6),
              ev("k", 5.4, 5.6),              # the ladder's self time
              ev("k", 5.5, 5.6),              # the boundary's start
              ev("k", 8.5, 8.6),
              ev("k", 9.5, 9.6)]              # after every span
    run_ = kernels_run(spans, events)
    assert reader("kernels_per_instance.ladder").read(run_) == 2.0
    assert load_module("metrics", "kernels_per_instance").read(run_) == 3.5


def test_ladder_kernels_read_nothing_without_a_ladder_or_a_trace():
    r = reader("kernels_per_instance.ladder")
    ev = trace.DeviceEvent("k", 0.5, 0.6)
    assert r.read(stage_run(dict(STAGE_TIMES))) is None
    assert r.read(kernels_run([("boundary", 0.0, 1.0)], [ev])) is None
    assert r.read(kernels_run([("ladder", 0.0, 1.0)], [])) is None
    assert r.read(kernels_run([("ladder", 0.0, 1.0)], [ev], 0)) is None
    # the parent: one "ladder" key
    assert r.read(kernels_run([("ladder", 0.0, 1.0)], [ev], 1)) == 1.0


def test_idle_gaps_are_named_by_the_ladder_leaves():
    ev = trace.DeviceEvent
    events = [ev("void f(int)", 0.0, 0.5), ev("void g(int)", 2.0, 2.5),
              ev("void h(int)", 3.0, 3.5)]
    spans = [("ladder/build", 0.0, 2.2), ("ladder/build#passes", 2.2, 2.2),
             ("ladder/balance", 2.2, 3.6)]
    gaps = dict(trace.idle_gaps(events, 3.6, spans))
    assert gaps == {"ladder/build: before g": pytest.approx(1.5),
                    "ladder/balance: before h": pytest.approx(0.5),
                    "ladder/balance: before end": pytest.approx(0.1)}


def test_solver_gs_writes_what_the_readers_read(monkeypatch):
    """chimera-32 on the CPU through the device cell's entry point, with the
    ladder on the card's default path (the device ladder): the stage
    readers all read a number, and a StageSpans dict gives each rung's
    sub-spans their own intervals."""
    import tnax_torch as tt
    from benchmark.harness import cell, instances
    monkeypatch.setattr(tt.Solver, "precondition", functools.partialmethod(
        tt.Solver.precondition, path="device"))
    c = cell.load_cell("c2048-gs-device")
    cfg = dict(c.config, instance=dict(c.config["instance"], cells=2),
               solver=dict(c.config["solver"], Dmax=16, M=16))
    unit = list(enumerate(instances.make_pool(2, 2 ** 31 + 7, 1)))
    spans = trace.StageSpans()
    answers = c.driver().run(tt, cfg, c.traffic["params"], unit,
                             torch.device("cpu"), torch.float64, spans)
    assert len(answers) == 1
    run_ = stage_run(dict(spans), completed=1)
    got = {name: reader(name).read(run_) for name in STAGE_READERS}
    assert None not in got.values(), got
    assert got["ladder_build_s_per_instance"] \
        + got["ladder_balance_s_per_instance"] \
        <= reader("ladder_s_per_instance").read(run_)
    assert got["variational_s_per_instance.ladder"] \
        <= got["ladder_build_s_per_instance"]
    assert 0 <= got["dispatch_s_per_instance.ladder"] \
        <= reader("ladder_s_per_instance").read(run_)
    for stage in ("ladder", "boundary"):
        assert 1 <= got[f"passes_per_row.{stage}"] <= 20
    names = [name for name, _ in spans.ends]
    assert names.count("ladder/build") == 2 and len(names) < 40
    ends = [t for _, t in spans.ends]
    assert ends == sorted(ends)
