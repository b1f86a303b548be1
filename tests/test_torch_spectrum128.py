"""Port parity of the low-energy spectrum at full width (Np = 256) on the
committed chimera-128 instance, in float64 on the CPU, against tnax: ee=2,
M=256, D=8, cutoff 1e-8, max_dEng=1.0 after ``np.random.seed(7);
add_noise(1e-7)``, tnax's sketch matrices handed to the port. The first
pass (cap 8*M) takes the prob-ordered top C and overflows; auto_grow's
retry takes tnax's compact order. Both packages must take the same passes
and decode the same 118 states with the same degeneracy.

The instance has no fields, so every state and its global spin flip have
equal energies (and probabilities equal up to rounding, which decides
which of the two a package meets first): the lists are compared as
(energy, state) sets, sorted."""

import os

import numpy as np
import scipy.sparse

import tnax
import tnax_torch as tt
from tnax import spectrum as jspec
from tnax_torch import spectrum
from torch_helpers import tnax_omega

PATH = os.path.join(os.path.dirname(__file__), "data",
                    "chimera128_synth_s0.txt")


def sorted_spectrum(ins):
    """The decoded (energies, states) sorted by energy (rounded to 1e-9),
    then by state."""
    E = np.asarray(ins.energy)
    order = np.lexsort(tuple(ins.states.T[::-1]) + (np.round(E, 9),))
    return E[order], ins.states[order]


def _run(pkg, monkeypatch, mod):
    passes = []
    search = mod.device_search_spectrum

    def watched(*a, **kw):
        r = search(*a, **kw)
        passes.append((kw["cand_factor"], r.merge_overflow, r.count_max))
        return r
    monkeypatch.setattr(mod, "device_search_spectrum", watched)
    J = pkg.round_Jij(pkg.Jij_f2p(pkg.load_Jij(PATH)), 1 / 75)
    kw = dict(device="cpu") if pkg is tt else {}
    ins = pkg.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3, **kw)
    np.random.seed(7)
    ins.add_noise(1e-7)
    skw = dict(omega=tnax_omega) if pkg is tt else {}
    ins.search_low_energy_spectrum(excitations_encoding=2, M=256,
                                   relative_P_cutoff=1e-8, Dmax=8,
                                   max_dEng=1.0, path="device", **skw)
    ins.decode_low_energy_states(max_dEng=1.0)
    return ins, passes


def test_spectrum_chimera128_matches_tnax(monkeypatch):
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    want, passes_j = _run(tnax, monkeypatch, jspec)
    got, passes = _run(tt, monkeypatch, spectrum)
    assert passes == passes_j
    # a first pass that overflows in the top-C order, a retry in the
    # compact order that does not
    assert len(passes) == 2 and passes[0][1] > 0 and passes[-1][1] == 0
    M = 256
    assert spectrum.records_select(passes[0][0] * M, M) == "topk"
    assert spectrum.records_select(passes[-1][0] * M, M) == "compact"
    assert got.cand_factor == passes[-1][0]
    assert got.spectrum_passes == passes
    assert got.merge_overflow == want.merge_overflow == 0
    assert len(got.energy) == len(want.energy) == 118
    assert got.degeneracy == want.degeneracy
    E, S = sorted_spectrum(got)
    E_j, S_j = sorted_spectrum(want)
    np.testing.assert_allclose(E, E_j, rtol=0, atol=1e-10)
    assert np.array_equal(S, S_j)
    # the decoded energies are those of the noisy couplings
    J = [list(t) for t in zip(*scipy.sparse.find(got.problem.J))]
    assert np.abs(tt.energy_Jij(J, got.binary_states()) - got.energy).max() \
        < 1e-9
