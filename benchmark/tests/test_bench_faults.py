"""A whole run without the look for a card, on the CPU at a small size,
with the timed path broken underneath: ``correct`` has to come out false
for each fault the cells can have (an answer altered where it is
produced; half of a batch left out), and true with nothing broken."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import cell


def small_cell(name):
    c = cell.load_cell(name)
    c.config["instance"]["cells"] = 2
    c.config["solver"].update(Dmax=16, M=16, dtype="float64")
    c.traffic.update(warmup_cells=2, pool=c.traffic["batch"] * 2)
    return c


def run_small(name, **params):
    c = small_cell(name)
    c.traffic["params"].update(params)
    return run.run_cell(c, 2 ** 31 + 99, 0.01, False, torch.device("cpu"))


@pytest.mark.parametrize("name", ["c2048-gs-device", "c512x8-gs-fleet"])
def test_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["checks"]


def _flip_state(states):
    states = np.array(states, copy=True)
    states[..., 0] ^= 1
    return states


def test_altered_state_is_not_correct(monkeypatch):
    import tnax_torch as tt
    search = tt.Solver.search_ground_state

    def altered(self, *a, **kw):
        out = search(self, *a, **kw)
        self.states = _flip_state(self.states)
        return out
    monkeypatch.setattr(tt.Solver, "search_ground_state", altered)
    r = run_small("c2048-gs-device")
    assert not r["correct"]
    assert r["checks"]["recheck_gap"]["value"] > 0


@pytest.mark.parametrize("field, change, check", [
    ("states", None, "recheck_gap"), ("energy", 1, "recheck_gap"),
    ("degeneracy", -1, "degeneracy_shortfall")])
def test_altered_fleet_answer_is_not_correct(monkeypatch, field, change,
                                             check):
    """(The degeneracy is compared where the merge is complete: the small
    cell runs the full expansion, cand_factor=None.)"""
    import tnax_torch as tt
    fleet = tt.parallel.multi_flagship_search_gs

    def altered(*a, **kw):
        out = fleet(*a, **kw)
        for r in out:
            if field == "states":
                r["states"] = _flip_state(r["states"])
            else:
                r[field] = r[field] + change
        return out
    monkeypatch.setattr(tt.parallel, "multi_flagship_search_gs", altered)
    r = run_small("c512x8-gs-fleet", cand_factor=None)
    assert not r["correct"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    import tnax_torch as tt
    fleet = tt.parallel.multi_flagship_search_gs

    def half(solvers, *a, **kw):
        return fleet(list(solvers)[: len(solvers) // 2], *a, **kw)
    monkeypatch.setattr(tt.parallel, "multi_flagship_search_gs", half)
    r = run_small("c512x8-gs-fleet")
    assert not r["correct"]
    assert r["failed"] > 0 and r["checks"]["missing"]["value"] > 0
