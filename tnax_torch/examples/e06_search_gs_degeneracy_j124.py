"""Ground-state degeneracy of J124 chimera instances: run all 4 rotations,
report the best energy and max degeneracy (the port of tnax's
``examples/e06_search_gs_degeneracy_j124.py``, reference
`examples/e06_search_gs_degeneracy_J124.py`)."""

import argparse
import logging
import time

import numpy as np

from ..solver import Solver
from .common import add_device_argument, load_j124_instance

J124_SHAPES = {8: (8, 8, 8), 12: (12, 12, 8), 16: (16, 16, 8)}


def search_gs_J124(C=8, instance=1, rot=0, beta=0.75, D=48, M=4096,
                   relative_P_cutoff=1e-8, precondition=True, device=None):
    Nx, Ny, Nc = J124_SHAPES[C]
    J = load_j124_instance(C, instance)
    ins = Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, J=J, beta=beta,
                 device=device)
    if rot > 0:
        ins.rotate_graph(rot=rot)
    if precondition:
        ins.precondition(mode="balancing")
    ins.search_ground_state(M=M, relative_P_cutoff=relative_P_cutoff, Dmax=D)
    return ins


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-C", type=int, choices=[8, 12, 16], default=8)
    p.add_argument("-ins", type=int, default=1)
    p.add_argument("-b", type=float, default=0.75)
    p.add_argument("-D", type=int, default=48)
    p.add_argument("-M", type=int, default=2 ** 12)
    p.add_argument("-P", type=float, default=1e-8)
    p.add_argument("-no-pre", dest="pre", action="store_false")
    add_device_argument(p)
    p.set_defaults(pre=True)
    args = p.parse_args()

    logging.basicConfig(level="INFO")
    t0 = time.time()
    energies, degs = [], []
    for rot in range(4):
        ins = search_gs_J124(C=args.C, instance=args.ins, rot=rot,
                             beta=args.b, D=args.D, M=args.M,
                             relative_P_cutoff=args.P, precondition=args.pre,
                             device=args.device)
        energies.append(ins.energy[0])
        degs.append(ins.degeneracy)
        print(f"rotation {rot}: E = {ins.energy[0]}, "
              f"degeneracy = {ins.degeneracy}")
    best = int(np.argmin(energies))
    Emin = energies[best]
    deg = max(d for e, d in zip(energies, degs) if abs(e - Emin) < 1e-9)
    print(f"Best energy  : {Emin}")
    print(f"Degeneracy   : {deg}")
    print(f"Total time   : {time.time() - t0:.2f} s")
