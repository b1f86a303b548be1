"""Port parity of the host balancing sweeps and tnax's named
preconditioner functions (tnax_torch.precondition) and of
Solver.precondition on every path and direction, against tnax in
float64 on the CPU with tnax's sketch matrices: gauges to 1e-10 (they
are powers of two, so in fact exactly), the overlaps_ud bookkeeping,
the gauge invariants exactly, and the ground-state energy unchanged by
'lr' (tnax's tests/test_mps_api.py:45)."""

import numpy as np
import pytest
import torch

import tnax
import tnax_torch as tt
from tnax import engine as jengine
from tnax import precondition as jpre
from tnax_torch import precondition
from test_search_small import make_chimera_like
from torch_helpers import tnax_omega

KEYS = ("Xl", "Xr", "Xu", "Xd")
# 3x4 cells of 4 spins: lh = lv = 16, so the D=8 boundaries truncate and
# their site tensors (whose norms enter the overlaps) have no free
# zero-channel basis
SIZE = dict(Nx=3, Ny=4, Nc=4)


@pytest.fixture(autouse=True)
def _tnax_sketch(monkeypatch):
    # tnax's host sweeps and 'lr' read the ambient zip-up default
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")


def _pair(seed=7, beta=2, size=SIZE):
    J = make_chimera_like(np.random.default_rng(seed), size["Nx"],
                          size["Ny"], size["Nc"])
    return (tnax.Solver(mode="Ising", beta=beta, J=J, **size),
            tt.Solver(mode="Ising", beta=beta, J=J, device="cpu", **size))


def _same_gauges(got, want):
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)


def _same_overlaps(got, want):
    """overlaps_ud to rtol 1e-9, not the gauges' 1e-10. The overlaps are
    small (1e-8..1e-5) and come from the stacks, which the two packages
    round differently in the last bits: one overlap of the second rung of
    test_balance_ud_and_lr_match_tnax differs by 5.4e-16 absolute, 1.3e-10
    of its value; the others agree to 1.5e-12 or better."""
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_host_helpers_are_tnax_s():
    rng = np.random.default_rng(0)
    D, d = 5, 6
    RL, RR = rng.standard_normal((D, D)), rng.standard_normal((D, D))
    p, a = rng.standard_normal((D, d, D)), rng.standard_normal((D, d, D))
    for name, args in (("_mix_left", (RL, p, a)), ("_mix_right", (RR, p, a)),
                       ("_bond_env", (RL, p, a, RR)),
                       ("_expectation", (RL, RR, p, a)), ("_norm", (a,))):
        assert np.array_equal(getattr(precondition, name)(*args),
                              getattr(jpre, name)(*args)), name
    env = rng.standard_normal((d, d)) * np.exp2(rng.integers(-20, 20, (d, 1)))
    assert np.array_equal(precondition._balance_scale(env, 32.0),
                          jpre._balance_scale(env, 32.0))
    for fn in ("_orth_right_absorb", "_orth_left_absorb"):
        A1 = [rng.standard_normal((D, d, D)) for _ in range(3)]
        A2 = [x.copy() for x in A1]
        getattr(precondition, fn)(A1, 1)
        getattr(jpre, fn)(A2, 1)
        for x, y in zip(A1, A2):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-14)


def test_balance_ud_and_lr_match_tnax():
    """Two rungs of 'ud' then 'lr', each from the last one's gauges, as
    the Solver calls them."""
    ins_j, ins = _pair()
    g0 = jengine.identity_gauges(jengine.pad_grid(ins_j.problem))
    Xj, Xt = g0, g0
    for beta in (1.0, 2.0):
        ov_j, ov_t = [], []
        Xj = jpre.balance_ud(ins_j.problem, beta, Xj, overlaps_out=ov_j)
        Xt = precondition.balance_ud(ins.problem, beta, Xt, overlaps_out=ov_t,
                                     device="cpu", omega=tnax_omega)
        _same_gauges(Xt, Xj)
        _same_overlaps(ov_t[0], ov_j[0])
        Xj = jpre.balance_lr(ins_j.problem, beta, Xj)
        Xt = precondition.balance_lr(ins.problem, beta, Xt, device="cpu",
                                     omega=tnax_omega)
        _same_gauges(Xt, Xj)
    assert not np.allclose(Xt["Xd"], 1.0) and not np.allclose(Xt["Xr"], 1.0)
    assert np.array_equal(Xt["Xd"][:-1] * Xt["Xu"][1:], np.ones_like(
        Xt["Xu"][1:]))
    assert np.array_equal(Xt["Xr"][:, :-1] * Xt["Xl"][:, 1:], np.ones_like(
        Xt["Xl"][:, 1:]))


def test_device_ladders_match_tnax():
    """precondition_ladder_device against tnax's; balance_ud_device is
    its one-rung case, and precondition_fleet (two instances in one
    batch) gives each instance its own ladder's gauges bit for bit, hence
    tnax's (whose own fleet test needs an absent reference checkout)."""
    (ins_j, ins), (_, ins2) = _pair(7), _pair(8)
    g0 = jengine.identity_gauges(jengine.pad_grid(ins_j.problem))
    kw = dict(device="cpu", omega=tnax_omega)
    betas = [0.5, 1.0]
    ov_j, ov_t = [], []
    ladder = precondition.precondition_ladder_device(
        ins.problem, betas, g0, overlaps_out=ov_t, **kw)
    _same_gauges(ladder, jpre.precondition_ladder_device(
        ins_j.problem, betas, g0, overlaps_out=ov_j))
    assert len(ov_t) == len(ov_j) == 2
    for a, b in zip(ov_t, ov_j):
        _same_overlaps(a, b)
    ov_1, ov_r = [], []
    one = precondition.balance_ud_device(ins.problem, 0.5, g0,
                                         overlaps_out=ov_1, **kw)
    rung = precondition.precondition_ladder_device(
        ins.problem, [0.5], g0, overlaps_out=ov_r, **kw)
    for k in KEYS:
        assert np.array_equal(one[k], rung[k]), k
    assert np.array_equal(ov_1[0], ov_r[0]) and np.array_equal(ov_1[0],
                                                               ov_t[0])
    fleet = precondition.precondition_fleet([ins.problem, ins2.problem],
                                            betas, **kw)
    for s, got in zip((ins, ins2), fleet):
        want = precondition.precondition_ladder_device(s.problem, betas, g0,
                                                       **kw)
        for k in KEYS:
            assert np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        other = tt.Solver(mode="Ising", Nx=2, Ny=2, Nc=4, beta=2,
                          J=make_chimera_like(np.random.default_rng(1), 2, 2,
                                              4), device="cpu")
        precondition.precondition_fleet([ins.problem, other.problem], betas,
                                         **kw)


@pytest.mark.parametrize("path,directions", [
    ("host", ("ud", "lr")), ("host", ("lr", "ud")), (None, ("ud",))])
def test_solver_precondition_matches_tnax(path, directions):
    """Solver.precondition on the host path in each order of directions,
    two rungs at D=8 after noise; path=None on the CPU is tnax's default
    there, the host sweeps. (tests/test_torch_solver_context.py's
    test_unported_paths_raise holds host 'ud' and device 'ud' + 'lr' to
    tnax.)"""
    ins_j, ins = _pair()
    for s in (ins_j, ins):
        np.random.seed(7)
        s.add_noise(1e-7)
    ins_j.precondition(path=path, directions=directions)
    stages = {}
    ins.precondition(path=path, directions=directions, omega=tnax_omega,
                     stage_times=stages)
    X = {k: v[0].numpy() for k, v in ins._gauges.items()}
    assert all(v.dtype == torch.float64 for v in ins._gauges.values())
    _same_gauges(X, ins_j._gauges)
    assert np.array_equal(X["Xd"][:-1] * X["Xu"][1:],
                          np.ones_like(X["Xu"][1:]))
    assert np.array_equal(X["Xr"][:, :-1] * X["Xl"][:, 1:],
                          np.ones_like(X["Xl"][:, 1:]))
    assert ins.overlaps_ud.shape == ins_j.overlaps_ud.shape == (4, 3)
    _same_overlaps(ins.overlaps_ud, ins_j.overlaps_ud)
    want = {"ud builds", "ud sweeps"}
    if "lr" in directions:
        want |= {"lr builds", "lr sweeps"}
    # the stages' keys, and each build's counters after its key
    assert {k for k in stages if "#" not in k} == want
    assert {k.split("#")[0] for k in stages} == want
    assert {k for k in stages if k.endswith("#rows")} == \
        {f"{k}#rows" for k in want if k.endswith("builds")}


def test_lr_keeps_the_ground_state_energy():
    """'ud' and 'lr' gauges leave the contraction, hence the ground state,
    unchanged (tnax's test_lr_preconditioning_invariant), and the search
    on them gives tnax's energy and degeneracy."""
    size = dict(Nx=3, Ny=3, Nc=2)
    rng = np.random.default_rng(2)
    J = make_chimera_like(rng, **size)
    kw = dict(M=128, relative_P_cutoff=1e-12, Dmax=8)
    ins0 = tt.Solver(mode="Ising", beta=2, J=J, device="cpu", **size)
    E0 = ins0.search_ground_state(omega=tnax_omega, **kw)[0]
    ins = tt.Solver(mode="Ising", beta=2, J=J, device="cpu", **size)
    ins.precondition(mode="balancing", directions=("ud", "lr"),
                     omega=tnax_omega)
    X = {k: v[0].numpy() for k, v in ins._gauges.items()}
    assert np.max(np.abs(X["Xd"][:-1] * X["Xu"][1:] - 1)) < 1e-12
    assert np.max(np.abs(X["Xr"][:, :-1] * X["Xl"][:, 1:] - 1)) < 1e-12
    assert not np.allclose(X["Xr"], 1.0)
    E1 = ins.search_ground_state(omega=tnax_omega, **kw)[0]
    assert E1 == pytest.approx(E0, abs=1e-9)
    ins_j = tnax.Solver(mode="Ising", beta=2, J=J, **size)
    ins_j.precondition(mode="balancing", directions=("ud", "lr"))
    assert ins_j.search_ground_state(**kw)[0] == pytest.approx(E1, abs=1e-9)
    assert ins.degeneracy == ins_j.degeneracy
    assert np.array_equal(ins.states, ins_j.states)


def test_bad_path_and_direction_raise():
    _, ins = _pair(size=dict(Nx=2, Ny=2, Nc=4))
    with pytest.raises(ValueError, match="path"):
        ins.precondition(path="gpu")
    with pytest.raises(ValueError, match="directions"):
        ins.precondition(directions=("ud", "diag"))
    with pytest.raises(ValueError, match="balancing"):
        ins.precondition(mode="other")
    assert ins._gauges is None      # nothing ran
