"""The port's recorder of stage seconds and counters
(``config.StageClock``) on the CPU: the balancing ladder's sub-spans and
the boundary builds' counters on chimera-32 and chimera-128 droplet-like
instances in float64, nothing recorded or synchronized without a dict,
and answers bit-identical with and without one."""

import numpy as np
import pytest
import torch

import tnax_torch as tt
from tnax_torch import config, engine, parallel
from torch_helpers import droplet_J

GS = dict(M=32, relative_P_cutoff=1e-8, Dmax=8)
LEAVES = ("ladder/peps", "ladder/build", "ladder/balance")


def _solver(J, n=2):
    return tt.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, beta=3, J=J,
                     device="cpu")


def _device_unit(J, st, n=2, **pre):
    ins = _solver(J, n)
    ins.precondition(path="device", stage_times=st, **pre)
    ins.search_ground_state(path="device", stage_times=st, **GS)
    return ins


def _stage(st, stage, counter):
    """The sum of ``counter`` over the keys of ``stage``."""
    return sum(v for k, v in st.items()
               if k.split("#")[0].split("/")[0] == stage
               and k.endswith("#" + counter))


def _assert_counters(st, stage, rows, max_sweeps):
    assert _stage(st, stage, "rows") == rows
    passes = _stage(st, stage, "passes")
    assert 1 <= passes / rows <= max_sweeps
    assert _stage(st, stage, "variational_s") > 0
    assert _stage(st, stage, "wait_s") > 0
    assert all(v > 0 for v in st.values())


class Writes(dict):
    """A ``stage_times`` dict that keeps the order of its writes."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.writes.append(key)


@pytest.mark.parametrize("n", [2, 4])
def test_solver_device_ladder_writes_leaves_and_counters(n):
    st = Writes()
    _device_unit(droplet_J(n), st, n)
    rungs = 2
    for leaf in LEAVES:
        assert st.writes.count(leaf) == rungs
    assert st.writes.count("ladder") == rungs
    assert st["ladder"] >= sum(st[k] for k in LEAVES)
    # the rows of each rung's D=8 build, counted at its build leaf
    assert st["ladder/build#rows"] == rungs * n
    _assert_counters(st, "ladder", rungs * n, 20)
    assert st["ladder/build#variational_s"] <= st["ladder/build"]
    _assert_counters(st, "boundary", n, 20)
    assert {"boundary", "search"} <= set(st)
    # a counter follows its key at once
    for i, k in enumerate(st.writes):
        if "#" in k:
            assert st.writes[i - 1].split("#")[0] == k.split("#")[0]
    assert len(st.writes) < 40
    assert config.recording() is None


def test_fleet_ladder_writes_leaves_and_counters():
    Js = [droplet_J(2, s) for s in (1, 2, 3)]
    st = Writes()
    parallel.multi_flagship_search_gs([_solver(J) for J in Js],
                                      stage_times=st, **GS)
    for leaf in LEAVES:
        assert st.writes.count(leaf) == 1       # one rung
    assert st["ladder"] >= sum(st[k] for k in LEAVES)
    # the fleet's 2B lanes are one build: one count per absorbed row
    _assert_counters(st, "ladder", 2, 20)
    _assert_counters(st, "boundary", 2, 2)
    assert {"peps", "search"} <= set(st)
    assert len(st.writes) < 40


def test_host_ladder_counts_its_builds():
    st = {}
    ins = _solver(droplet_J())
    ins.precondition(path="host", directions=("ud", "lr"), stage_times=st)
    for stage in ("ud builds", "lr builds"):
        assert st[f"{stage}#rows"] == 2 * 2       # two rungs of Ny rows
        assert 1 <= st[f"{stage}#passes"] / st[f"{stage}#rows"] <= 20
        assert st[f"{stage}#wait_s"] > 0         # the stop reads, the pull
    assert st["ud sweeps#wait_s"] > 0            # the gauges' pull
    assert not any(k.startswith("ladder") for k in st)


def test_host_search_counts_the_boundary():
    st = {}
    ins = _solver(droplet_J())
    ins.search_ground_state(path="host", stage_times=st, **GS)
    assert st["boundary#rows"] == 2
    assert st["boundary#passes"] >= 2
    assert set(st) >= {"boundary", "search"}


def _answers(ins):
    return (ins.energy.tolist(), ins.states.tolist(), ins.degeneracy,
            ins.probability.tolist(), ins.overlaps_ud.tolist(),
            {k: v.numpy().tolist() for k, v in ins._gauges.items()})


def test_answers_are_bit_identical_with_and_without_a_dict():
    J = droplet_J(2, 9)
    assert _answers(_device_unit(J, {})) == _answers(_device_unit(J, None))
    Js = [droplet_J(2, s) for s in (4, 5)]
    got = [parallel.multi_flagship_search_gs([_solver(J) for J in Js],
                                             stage_times=st, **GS)
           for st in ({}, None)]
    for a, b in zip(*got):
        assert a["energy"] == b["energy"] and a["prob"] == b["prob"]
        assert a["degeneracy"] == b["degeneracy"]
        assert np.array_equal(a["states"], b["states"])


def _refuse(*args, **kw):
    raise AssertionError("recorded without a dict")


@pytest.fixture
def seen(monkeypatch):
    """The clock that :func:`config.recording` gives each stack build."""
    clocks = []
    build = engine._build_stack

    def spy(*args, **kw):
        clocks.append(config.recording())
        return build(*args, **kw)

    monkeypatch.setattr(engine, "_build_stack", spy)
    return clocks


def test_nothing_is_recorded_or_synchronized_without_a_dict(monkeypatch,
                                                             seen):
    for name in ("leaf", "count", "read", "_write"):
        monkeypatch.setattr(config.StageClock, name, _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    _device_unit(droplet_J(), None)
    ins = _solver(droplet_J())
    ins.precondition(path="host", directions=("ud", "lr"))
    ins.search_ground_state(path="host", **GS)
    parallel.multi_flagship_search_gs([_solver(droplet_J())], **GS)
    assert len(seen) >= 6 and set(seen) == {None}


def test_a_traced_call_leaves_recording_off(monkeypatch, seen):
    first = {}
    _device_unit(droplet_J(), first)
    assert len(seen) == 3 and None not in seen
    before = dict(first)
    _device_unit(droplet_J(), None)
    assert len(seen) == 6 and seen[3:] == [None] * 3
    assert first == before

    def fail(*args, **kw):
        raise RuntimeError("a stage that fails")

    monkeypatch.setattr(engine, "build_rho_both", fail)
    with pytest.raises(RuntimeError):
        _solver(droplet_J()).precondition(path="device", stage_times={})
    assert config.recording() is None


def test_nested_clocks_restore_the_outer_one():
    outer, inner = {}, {}
    with config.StageClock(outer, torch.device("cpu")) as a:
        assert config.recording() is a
        with config.StageClock(None, torch.device("cpu")):
            assert config.recording() is a
        with config.StageClock(inner, torch.device("cpu")) as b:
            assert config.recording() is b
            b.count("rows", 3)
            b.lap("boundary")
        assert config.recording() is a
        a.count("passes", 0)           # zero counters are not written
        a.leaf("ladder/build")
        a.lap("ladder")
    assert config.recording() is None
    assert set(inner) == {"boundary", "boundary#rows"}
    assert inner["boundary#rows"] == 3
    assert set(outer) == {"ladder/build", "ladder"}
    assert outer["ladder"] >= outer["ladder/build"]
