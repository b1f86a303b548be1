"""Port parity of the rest of the Solver against tnax's, in float64 on the
CPU: the host-exact low-energy spectrum (three encodings, decoded lists
and droplet shapes), RMF problems (the 3x5 Potts model of the e05
example, ``energy_RMF``, rotations and noise, both search paths),
``save``/``load`` both ways between the packages, the ``show_*``
displays, and a Solver built without couplings. tnax's sketch matrices
are handed to the port's zip-up. Inputs are made with numpy from
seeds."""

import numpy as np
import pytest
import torch

import tnax
import tnax_torch as tt
from test_search_small import make_chimera_like
from torch_helpers import tnax_omega

SPEC = dict(M=64, relative_P_cutoff=1e-8, Dmax=8, max_dEng=6.0)


@pytest.fixture(autouse=True)
def _tnax_sketch(monkeypatch):
    # tnax's spectrum boundary reads the ambient zip-up default
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")


def _ising_pair(seed=3, noise=True):
    J = make_chimera_like(np.random.default_rng(seed), 2, 2, 4)
    pair = (tnax.Solver(mode="Ising", Nx=2, Ny=2, Nc=4, beta=1, J=J),
            tt.Solver(mode="Ising", Nx=2, Ny=2, Nc=4, beta=1, J=J,
                      device="cpu"))
    for s in pair:
        s.rotate_graph(rot=1)
        if noise:
            np.random.seed(7)
            s.add_noise(1e-7)
    return pair


def _spectrum_pair(ee, native=True):
    ins_j, ins = _ising_pair()
    ins_j.search_low_energy_spectrum(excitations_encoding=ee, **SPEC)
    ins.search_low_energy_spectrum(excitations_encoding=ee, omega=tnax_omega,
                                   native=native, **SPEC)
    return ins_j, ins


def _shapes(ins):
    return {(p.tobytes(), s.tobytes()) for p, s in ins.d.values()}


def assert_same_trees(got, want, tol=1e-10):
    """Two droplet trees node for node: the same keys and sites, the same
    energies and log2-probability gaps within ``tol``."""
    assert len(got) == len(want)
    for (hg, cg), (hw, cw) in zip(got, want):
        assert len(hg) == len(hw)
        for a, b in zip(hg, hw):
            if isinstance(b, (int, np.integer)):
                assert a == b
            else:
                assert a == pytest.approx(b, rel=0, abs=tol)
        assert_same_trees(cg, cw, tol)


def _assert_same_lists(got, want):
    assert len(got.energy) == len(want.energy)
    np.testing.assert_allclose(got.energy, want.energy, rtol=0, atol=1e-10)
    assert np.array_equal(got.states, want.states)
    assert got.degeneracy == want.degeneracy


@pytest.mark.parametrize("ee,native", [(1, True), (2, True), (3, True),
                                       (2, False)])
def test_host_spectrum_matches_tnax(ee, native):
    ins_j, ins = _spectrum_pair(ee, native)
    assert _shapes(ins) == _shapes(ins_j) and len(ins.d) > 5
    assert ins.free_d == ins_j.free_d
    assert_same_trees(ins.el, ins_j.el)
    assert not hasattr(ins, "spectrum_passes")   # no cap, no auto-grow
    ins_j.decode_low_energy_states(max_dEng=6.0, max_states=256)
    ins.decode_low_energy_states(max_dEng=6.0, max_states=256,
                                 native=native)
    _assert_same_lists(ins, ins_j)
    assert len(ins.energy) > 10


def test_host_spectrum_equals_device_spectrum():
    """The host path merges every candidate; the device path at the full
    expansion does too: the same decoded lists (as sorted (energy,
    state) sets)."""
    _, a = _ising_pair()
    _, b = _ising_pair()
    a.search_low_energy_spectrum(excitations_encoding=2, omega=tnax_omega,
                                 **SPEC)
    b.search_low_energy_spectrum(excitations_encoding=2, omega=tnax_omega,
                                 path="device", cand_factor=None, **SPEC)
    for s in (a, b):
        s.decode_low_energy_states(max_dEng=6.0, max_states=256)

    def pairs(s):
        return sorted((round(float(e), 9), tuple(x))
                      for e, x in zip(s.energy, s.states))
    assert pairs(a) == pairs(b)


def e05_model():
    """The 3x5 lattice of 3-state variables with Potts-like penalty
    factors of the e05 example."""
    Nx, Ny = 5, 3
    N = np.zeros((Ny, Nx), dtype=int) + 3
    fun = {1: np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]]),
           2: np.array([-1.5, 0, 1.5]),
           3: np.array([1.25, 0, -1.25])}
    fac = {}
    for ny in range(Ny):
        for nx in range(Nx - 1):
            fac[(ny, nx, ny, nx + 1)] = 1
    for ny in range(Ny - 1):
        for nx in range(Nx):
            fac[(ny, nx, ny + 1, nx)] = 1
    for nx in range(Nx):
        fac[(0, nx)] = 2
        fac[(1, nx)] = 3
        fac[(2, nx)] = 2
    return {"fun": fun, "fac": fac, "N": N, "Nx": Nx, "Ny": Ny}


def _rmf_pair(rot=0, noise=False, dtype=None):
    pair = (tnax.Solver(mode="RMF", Nx=5, Ny=3, J=e05_model(), beta=4),
            tt.Solver(mode="RMF", Nx=5, Ny=3, J=e05_model(), beta=4,
                      device="cpu", dtype=dtype))
    for s in pair:
        s.rotate_graph(rot=rot)
        if noise:
            np.random.seed(5)
            s.add_noise(1e-7)
    return pair


E05 = dict(M=1024, relative_P_cutoff=1e-12, Dmax=32, max_dEng=3.1)


@pytest.mark.parametrize("ee,rot", [(1, 0), (2, 1), (3, 0)])
def test_rmf_e05_host_spectrum_matches_tnax(ee, rot):
    """e05's spectrum: 26 states within dE = 3.1, tnax's lists and droplet
    shapes."""
    ins_j, ins = _rmf_pair(rot=rot, noise=ee > 1)
    assert ins.problem.J["fac"] == ins_j.problem.J["fac"]
    for k, v in ins_j.problem.J["fun"].items():
        assert np.array_equal(ins.problem.J["fun"][k], v)
    ins_j.search_low_energy_spectrum(excitations_encoding=ee, **E05)
    ins.search_low_energy_spectrum(excitations_encoding=ee, omega=tnax_omega,
                                   **E05)
    assert _shapes(ins) == _shapes(ins_j)
    if ee == 2:
        # the lattice's width comes with the adjacency (ee > 1), as in tnax
        assert tt.spectrum.exc_export_shapes(ins) == \
            tnax.spectrum.exc_export_shapes(ins_j)
    for s in (ins_j, ins):
        s.decode_low_energy_states(max_dEng=3.1, max_states=100)
    _assert_same_lists(ins, ins_j)
    assert len(ins.energy) == 26
    # the states in the unrotated lattice's order, energies within the
    # noise's reach
    np.testing.assert_allclose(tt.energy_RMF(e05_model(), ins.binary_states()),
                               ins.energy, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rmf_e05_both_paths(dtype):
    """The RMF widths (3 states, legs of 3) on the device paths: the
    spectrum decodes the same 26 energies as the host path, and both
    ground-state searches find e05's ground state."""
    _, a = _rmf_pair(dtype=dtype)
    _, b = _rmf_pair(dtype=dtype)
    a.search_low_energy_spectrum(excitations_encoding=1, **E05)
    b.search_low_energy_spectrum(excitations_encoding=1, path="device",
                                 **E05)
    for s in (a, b):
        s.decode_low_energy_states(max_dEng=3.1, max_states=100)
    assert len(a.energy) == len(b.energy) == 26
    np.testing.assert_allclose(np.sort(a.energy), np.sort(b.energy),
                               atol=1e-9)
    np.testing.assert_allclose(tt.energy_RMF(e05_model(), b.states),
                               b.energy, atol=1e-9)
    kw = dict(M=1024, relative_P_cutoff=1e-12, Dmax=32)
    a.search_ground_state(**kw)
    b.search_ground_state(path="device", **kw)
    assert a.energy[0] == pytest.approx(b.energy[0], abs=1e-9)
    assert a.energy[0] == pytest.approx(np.sort(a.energy)[0], abs=1e-9)


def test_energy_rmf_matches_tnax():
    rng = np.random.default_rng(2)
    states = rng.integers(0, 3, size=(64, 15))
    assert np.array_equal(tt.energy_RMF(e05_model(), states),
                          tnax.energy_RMF(e05_model(), states))


@pytest.mark.parametrize("writer", ["port", "tnax"])
def test_save_load_between_packages(writer, tmp_path):
    """A spectrum result (ee=2, so the file holds the adjacency) saved by
    one package loads in the other with equal fields, and the loaded
    solver decodes the same states."""
    ins_j, ins = _spectrum_pair(2)
    for s in (ins_j, ins):
        s.decode_low_energy_states(max_dEng=6.0, max_states=256)
    path = str(tmp_path / "result.npy")
    src = ins if writer == "port" else ins_j
    src.save(path)
    out = tnax.load(path) if writer == "port" \
        else tt.load(path, device="cpu")
    for k in ("energy", "states", "probability"):
        assert np.array_equal(getattr(out, k), getattr(src, k)), k
    for k in ("degeneracy", "discarded_probability", "negative_probability",
              "negative_probability_core", "excitations_encoding", "free_d",
              "mode", "beta", "Nx", "Ny", "L"):
        assert getattr(out, k) == getattr(src, k), k
    assert _shapes(out) == _shapes(src)
    assert np.array_equal(np.asarray(out.adj), np.asarray(src.adj))
    assert_same_trees(out.el, src.el, tol=0)
    assert np.array_equal(out.binary_states(), src.binary_states())
    gs = src.energy[0]
    out.decode_low_energy_states(max_dEng=6.0, max_states=256)
    np.testing.assert_allclose(out.energy, src.energy, atol=1e-10)
    assert np.array_equal(out.states, src.states)
    assert out.energy[0] == gs


def test_show_output_matches_tnax(capsys):
    ins_j, ins = _spectrum_pair(1)
    shown = []
    for s in (ins_j, ins):
        s.show_properties()
        s.show_solution(state=True)
        s.exc_print()
        tt.spectrum.exc_show_properties(s)
        shown.append(capsys.readouterr().out)
    assert shown[0] == shown[1]
    assert "|- " in shown[1] and "Degeneracy" in shown[1]
    empty = tt.Solver(mode="Ising", Nx=2, Ny=2, Nc=4, device="cpu")
    empty.show_solution()
    assert capsys.readouterr().out == "No solution to show.\n"


def test_solver_without_couplings_as_tnax():
    """Solver(J=None) holds results and decodes them as tnax's does; only
    the searches need couplings."""
    kw = dict(mode="Ising", Nx=3, Ny=2, Nc=4, beta=2)
    ins_j, ins = tnax.Solver(**kw), tt.Solver(device="cpu", **kw)
    for s in (ins_j, ins):
        assert (s.Nx, s.Ny, s.L, s.problem) == (3, 2, 24, None)
        with pytest.raises(ValueError, match="couplings"):
            s._context()
    with pytest.raises(ValueError, match="couplings"):
        ins.search_ground_state(M=4, Dmax=4)
    J = make_chimera_like(np.random.default_rng(4), 3, 2, 4)
    full = tt.Solver(J=J, device="cpu", **kw)
    states = np.random.default_rng(0).integers(0, 16, size=(5, 6))
    for s in (ins_j, ins, full):
        s.ind0 = full.ind0
        s.states = states
    assert np.array_equal(ins.binary_states(), full.binary_states())
    assert np.array_equal(ins.binary_states(2), ins_j.binary_states(2))
    rmf = tt.Solver(mode="RMF", Nx=5, Ny=3, device="cpu")
    assert (rmf.Nc, rmf.L) == (1, 15)
    with pytest.raises(ValueError, match="mode"):
        tt.Solver(mode="Potts", device="cpu")
    assert tt.tnac4o is tt.Solver


def test_only_the_host_ladder_and_lr_stay_unported():
    """The host ladder and 'lr' are ported now: on the rotated solver
    both preconditioner paths run in both directions and give tnax's
    gauges. Every method refuses a path that neither package has."""
    for path in ("host", "device"):
        ins_j, ins = _ising_pair(noise=False)
        ins_j.precondition(path=path, directions=("ud", "lr"))
        ins.precondition(path=path, directions=("ud", "lr"),
                         omega=tnax_omega)
        for k in ("Xl", "Xr", "Xu", "Xd"):
            np.testing.assert_allclose(ins._gauges[k][0].numpy(),
                                       ins_j._gauges[k], rtol=1e-10)
    for method in (ins.search_ground_state, ins.gibbs_sampling,
                   ins.search_low_energy_spectrum):
        with pytest.raises(ValueError, match="path"):
            method(M=4, Dmax=4, path="gpu")
    with pytest.raises(ValueError, match="path"):
        ins.precondition(path="gpu")
