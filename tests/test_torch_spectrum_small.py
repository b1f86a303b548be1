"""Port parity of the low-energy spectrum (Solver.search_low_energy_spectrum
on the device-record path, then decode_low_energy_states) against tnax, in
float64 on the CPU, on the 2x2 lattice of 4-spin blocks of tnax's own
fleet-spectrum test: the decoded lists (energies to 1e-10, states and
degeneracies exactly) and the droplet shape dictionaries, for the three
encodings, four rotations, the droplet store's C code and its NumPy
versions, a store built by tnax and decoded by the port, and the fleet."""

import numpy as np
import pytest

import tnax
import tnax_torch as tt
from tnax import spectrum as jspec
from tnax_torch import interop, spectrum
from test_search_small import make_chimera_like
from torch_helpers import tnax_omega

KW = dict(M=64, relative_P_cutoff=1e-10, Dmax=8, max_dEng=1.5)


def _toy(pkg, seed=0, rot=0):
    J = make_chimera_like(np.random.default_rng(seed), 2, 2, 4)
    kw = dict(device="cpu") if pkg is tt else {}
    ins = pkg.Solver(mode="Ising", Nx=2, Ny=2, Nc=4, beta=2, J=J, **kw)
    if rot:
        ins.rotate_graph(rot=rot)
    return ins


def _search(ins, ee, native=True, decode=True):
    kw = dict(KW, path="device")
    if isinstance(ins, tt.Solver):
        kw.update(omega=tnax_omega, native=native)
    ins.search_low_energy_spectrum(excitations_encoding=ee, **kw)
    if decode:
        dec = dict(native=native) if isinstance(ins, tt.Solver) else {}
        ins.decode_low_energy_states(max_dEng=1.5, max_states=256, **dec)
    return ins


def _shapes(ins):
    return {(p.tobytes(), s.tobytes()) for p, s in ins.d.values()}


def _assert_same(got, want):
    assert len(got.energy) == len(want.energy)
    np.testing.assert_allclose(got.energy, want.energy, rtol=0, atol=1e-10)
    assert np.array_equal(got.states, want.states)
    assert got.degeneracy == want.degeneracy
    assert got.merge_overflow == want.merge_overflow
    assert _shapes(got) == _shapes(want)


@pytest.fixture(autouse=True)
def _tnax_sketch(monkeypatch):
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")


@pytest.mark.parametrize("ee", [1, 2, 3])
def test_spectrum_matches_tnax(ee):
    want = _search(_toy(tnax), ee)
    got = _search(_toy(tt), ee)
    assert len(got.energy) > 5
    _assert_same(got, want)
    assert np.array_equal(got.binary_states(), want.binary_states())
    # the droplet trees themselves, key for key
    assert spectrum.excitations_to_list(got.el) \
        == jspec.excitations_to_list(want.el)


@pytest.mark.parametrize("rot", [1, 2, 3])
def test_spectrum_rotations_match_tnax(rot):
    want = _search(_toy(tnax, rot=rot), 1)
    got = _search(_toy(tt, rot=rot), 1)
    _assert_same(got, want)
    # decoded states come back in the unrotated cluster order
    assert np.array_equal(got.binary_states(), want.binary_states())
    E = tt.energy_Jij(make_chimera_like(np.random.default_rng(0), 2, 2, 4),
                      got.binary_states())
    np.testing.assert_allclose(E, got.energy, atol=1e-10)


@pytest.mark.parametrize("ee", [1, 2, 3])
def test_native_and_numpy_droplet_code_agree(ee):
    _assert_same(_search(_toy(tt, seed=1), ee, native=False),
                 _search(_toy(tt, seed=1), ee, native=True))


@pytest.mark.parametrize("ee", [1, 2])
def test_port_decodes_a_tnax_store(ee):
    src = _search(_toy(tnax), ee, decode=False)
    store = {k: getattr(src, k) for k in ("d", "invd", "el", "free_d",
                                          "excitations_encoding", "energy",
                                          "states")}
    if ee > 1:
        store.update(adj=src.adj, xor2ind=src.xor2ind)
    ins = _toy(tt)
    interop.droplet_store(ins, store)
    src.decode_low_energy_states(max_dEng=1.5, max_states=256)
    ins.decode_low_energy_states(max_dEng=1.5, max_states=256)
    assert np.array_equal(ins.states, src.states)
    np.testing.assert_allclose(ins.energy, src.energy, rtol=0, atol=1e-10)


@pytest.mark.parametrize("ee", [1, 2])
def test_fleet_spectrum_matches_single_runs(ee):
    singles = [_search(_toy(tt, seed=i), ee) for i in range(3)]
    inss = [_toy(tt, seed=i) for i in range(3)]
    rs = tt.multi_search_spectrum(inss, [ins._context() for ins in inss], ee,
                                  omega=tnax_omega, **KW)
    for ins, r, single in zip(inss, rs, singles):
        ins.set_result(r)
        ins.decode_low_energy_states(max_dEng=1.5, max_states=256)
        _assert_same(ins, single)
    # n_live replays only the first instances
    inss = [_toy(tt, seed=i) for i in range(3)]
    rs = tt.multi_search_spectrum(inss, [ins._context() for ins in inss], ee,
                                  omega=tnax_omega, n_live=2, **KW)
    assert len(rs) == 2
