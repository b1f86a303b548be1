"""The plain reference: exact on lattices small enough to enumerate, and
the port's answer on chimera-128 (CPU, float64)."""

import numpy as np
import pytest
import torch

from benchmark.harness import instances
from benchmark.reference import energy, gs_search


def brute_force(coupl, L):
    bits = (np.arange(2 ** L)[:, None] >> np.arange(L)[None, :]) & 1
    E = energy.energies(coupl, bits)
    return E.min(), int((E <= E.min() + 1e-9).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_on_one_row_of_two_cells(seed):
    rows = instances.droplet_file_rows(instances.chimera_couplings(
        2, instances.instance_rng(seed, 0)))
    coupl = [c for c in energy.couplings(rows) if c[1] < 16]  # row 0 only
    E, deg = brute_force(coupl, 16)
    r = gs_search.search(2, coupl, beta=3, Dmax=16, M=4096,
                         relative_P_cutoff=0)
    # row 1 is uncoupled: its 16 spins multiply the degeneracy
    assert r.energy == pytest.approx(E, abs=1e-12)
    assert r.degeneracy == deg * 2 ** 16
    assert energy.energies(coupl, r.bits)[0] == pytest.approx(r.energy,
                                                              abs=1e-12)


def test_energy_tables_match_the_plain_energy():
    rows = instances.droplet_file_rows(instances.chimera_couplings(
        3, instances.instance_rng(4, 0)))
    coupl = energy.couplings(rows)
    lat = gs_search.lattice(3, coupl)
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 256, size=(5, 9))
    bits = ((cells[:, :, None] >> np.arange(8)) & 1).reshape(5, -1)
    E = np.zeros(5)
    for y in range(3):
        for x in range(3):
            s = cells[:, 3 * y + x]
            E += lat.Eloc[y, x, s]
            if y:
                E += lat.Ev[y, x, cells[:, 3 * (y - 1) + x] & 15, s & 15]
            if x:
                E += lat.Eh[y, x, cells[:, 3 * y + x - 1] >> 4, s >> 4]
    assert np.allclose(E, energy.energies(coupl, bits), atol=1e-12)


def test_rejects_a_coupling_chimera_lacks():
    with pytest.raises(ValueError):
        gs_search.lattice(2, [(0, 8, 1.0)])      # spin 0 to the right


@pytest.mark.parametrize("seed", [0, 1])
def test_agrees_with_the_port_on_chimera128(seed):
    import tnax_torch as tt
    rows = instances.droplet_file_rows(instances.chimera_couplings(
        4, instances.instance_rng(seed, 0)))
    r = gs_search.search(4, energy.couplings(rows), beta=3, Dmax=16,
                         M=256, relative_P_cutoff=1e-8,
                         dtype=torch.float64)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8,
                    J=tt.round_Jij(tt.Jij_f2p(rows), 1 / 75), beta=3,
                    device="cpu")
    ins.precondition()
    ins.search_ground_state(M=256, relative_P_cutoff=1e-8, Dmax=16)
    assert r.energy == pytest.approx(float(ins.energy[0]), abs=1e-9)
    assert r.degeneracy == ins.degeneracy
