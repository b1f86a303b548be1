"""The port on the committed synthetic chimera-128 instance (true K4,4
cells, couplings in multiples of 1/75): its problem tables against tnax's,
the flagship search against the committed tnax oracle at the full slice
parameters (M=1024, D=32, cutoff 1e-8), and against tnax run live at a
smaller M and D. Float64 on the CPU."""

import json
import os

import numpy as np
import pytest

import tnax
from tnax import engine as jengine
from tnax import parallel as jpar
import tnax_torch as tt
from tnax_torch import engine
from test_torch_bmps import tnax_omega

DATA = os.path.join(os.path.dirname(__file__), "data")
INSTANCE = os.path.join(DATA, "chimera128_synth_s0.txt")


def _J():
    return tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)


def _recheck(J, ins, states):
    ins.states = np.asarray(states)[None, :][:, ins.order]
    return float(tt.energy_Jij(J, ins.binary_states())[0])


def test_problem_tables_match_tnax():
    J = _J()
    assert J == tnax.round_Jij(tnax.Jij_f2p(tnax.load_Jij(INSTANCE)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
    ref = tnax.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
    g, gj = engine.pad_grid(ins.problem), jengine.pad_grid(ref.problem)
    assert (g.Np, g.lh, g.lv) == (gj.Np, gj.lh, gj.lv) == (256, 16, 16)
    for k in ("Es", "Esl", "Esu", "dmap", "rmap", "nstates"):
        assert np.array_equal(getattr(g, k), getattr(gj, k)), k
    assert np.array_equal(ins.problem.ld, ref.problem.ld)
    rng = np.random.default_rng(0)
    states = rng.integers(0, 256, size=(5, 16)).astype(np.int32)
    ins.states, ref.states = states, states
    bits = ins.binary_states()
    assert np.array_equal(bits, ref.binary_states())
    assert np.array_equal(tt.energy_Jij(J, bits), tnax.energy_Jij(J, bits))


def test_flagship_matches_committed_oracle():
    with open(os.path.join(DATA, "chimera128_synth_s0_oracle.json")) as f:
        oracle = json.load(f)
    J = _J()
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
    res = tt.parallel.flagship_search_gs(
        ins, M=oracle["M"], relative_P_cutoff=oracle["relative_P_cutoff"],
        Dmax=oracle["Dmax"], zipup_rsvd=oracle["zipup_rsvd"],
        omega=tnax_omega)
    assert res["states"].tolist() == oracle["states"]
    assert res["degeneracy"] == oracle["degeneracy"]
    E = _recheck(J, ins, res["states"])
    assert E == pytest.approx(oracle["energy"], abs=1e-9)
    assert res["energy"] == pytest.approx(E, abs=1e-9)


def test_flagship_matches_tnax_smaller_beam(monkeypatch):
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    J = _J()
    kw = dict(M=128, relative_P_cutoff=1e-8, Dmax=16, zipup_rsvd=True)
    ref_ins = tnax.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
    want = jpar.flagship_search_gs(ref_ins, **kw)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
    got = tt.parallel.flagship_search_gs(ins, omega=tnax_omega, **kw)
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    assert got["degeneracy"] == want["degeneracy"]
    assert _recheck(J, ins, got["states"]) == pytest.approx(
        _recheck(J, ref_ins, want["states"]), abs=1e-9)
    assert got["merge_overflow"] == want["merge_overflow"]
    assert got["count_max"] == want["count_max"]
