"""``gs_excess`` is compared on the instances the reference settles (the
same energy at M and at ``settle_factor`` * M), and there it catches a
state above the reference's ground state (CPU, chimera-32)."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness import cell, instances
from benchmark.harness.answers import Answer
from benchmark.reference import energy


def small_config():
    cfg = copy.deepcopy(cell.load_cell("c2048-gs-device").config)
    cfg["instance"]["cells"] = 2
    cfg["solver"].update(Dmax=16, M=16)
    assert cfg["check"]["settle_factor"] > 1
    return cfg


def worse_answers(cfg, check, pool):
    """Each instance's reference state with one spin flipped, its energy
    reported exactly."""
    out = []
    for k, rows in enumerate(pool):
        coupl, ref = check.reference_search(cfg, rows, torch, "cpu")
        bits = np.array(ref.bits, copy=True)
        bits[0] ^= 1
        out.append(Answer(k, float(energy.energies(coupl, bits)[0]), bits,
                          1, ref.log2p))
    return out


def compare(cfg, check, pool, answers):
    numbers = check.compare(cfg, pool, range(len(pool)), answers, 5, torch,
                            "cpu", log=lambda m: None)
    return {name: (value, limit) for name, value, limit in numbers}


def test_a_worse_state_on_a_settled_instance_is_caught():
    cfg = small_config()
    check = cell.load_cell("c2048-gs-device").check()
    pool = instances.make_pool(2, 11, 2)
    got = compare(cfg, check, pool, worse_answers(cfg, check, pool))
    value, limit = got["gs_excess"]
    assert value > limit and value >= 2 / 75 - 1e-12
    assert not check.passed(list((n, v, lim) for n, (v, lim)
                                 in got.items()))


@pytest.mark.parametrize("unsettled", [[0], [0, 1]])
def test_an_unsettled_instance_is_not_compared(monkeypatch, unsettled):
    cfg = small_config()
    check = cell.load_cell("c2048-gs-device").check()
    pool = instances.make_pool(2, 11, 2)
    answers = worse_answers(cfg, check, pool)
    search = check.reference_search

    def wider_finds_lower(c, rows, *a, **kw):
        coupl, r = search(c, rows, *a, **kw)
        if c["solver"]["M"] > cfg["solver"]["M"] \
                and pool.index(rows) in unsettled:
            r.energy -= 2 / 75
        return coupl, r
    monkeypatch.setattr(check, "reference_search", wider_finds_lower)
    got = compare(cfg, check, pool, answers)
    value, limit = got["gs_excess"]
    if len(unsettled) == len(pool):
        assert value == 0.0
    else:
        assert value > limit       # the settled instance is still held
    assert got["recheck_gap"][0] <= got["recheck_gap"][1]
