"""Minimal Random Markov Field example: 3x5 lattice of 3-state variables
with Potts-like penalty factors (the port of tnax's
``examples/e05_minimal_rmf.py``, reference `examples/e05_minimal_RMF.py`)."""

import argparse
import logging

import numpy as np

from ..solver import Solver
from .common import add_device_argument


def build_model():
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


def minimal_RMF(rot=0, D=32, M=1024, relative_P_cutoff=1e-12,
                excitations_encoding=1, dE=3.1, hd=0, max_states=100,
                precondition=False, device=None):
    J = build_model()
    ins = Solver(mode="RMF", Nx=5, Ny=3, J=J, beta=4, device=device)
    if rot > 0:
        ins.rotate_graph(rot=rot)
    if excitations_encoding > 1:
        ins.add_noise(amplitude=1e-7)
    if precondition:
        ins.precondition(mode="balancing")
    ins.search_low_energy_spectrum(
        excitations_encoding=excitations_encoding, M=M,
        relative_P_cutoff=relative_P_cutoff, Dmax=D, max_dEng=dE, lim_hd=hd)
    ins.decode_low_energy_states(max_dEng=dE, max_states=max_states)
    return ins


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-r", type=int, default=0)
    p.add_argument("-D", type=int, default=32)
    p.add_argument("-M", type=int, default=2 ** 10)
    p.add_argument("-P", type=float, default=1e-12)
    p.add_argument("-dE", type=float, default=3.1)
    p.add_argument("-hd", type=int, default=0)
    p.add_argument("-max_st", type=int, default=2 ** 20)
    p.add_argument("-ee", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("-pre", dest="pre", action="store_true")
    add_device_argument(p)
    p.set_defaults(pre=False)
    args = p.parse_args()

    logging.basicConfig(level="INFO")
    ins = minimal_RMF(rot=args.r, D=args.D, M=args.M,
                      relative_P_cutoff=args.P, excitations_encoding=args.ee,
                      dE=args.dE, hd=args.hd, max_states=args.max_st,
                      precondition=args.pre, device=args.device)
    ins.show_solution()
    print("Energies of the found low-energy states:")
    print(ins.energy)
    print()
    print("Tree of droplets (indentation shows hierarchy):")
    ins.exc_print()
