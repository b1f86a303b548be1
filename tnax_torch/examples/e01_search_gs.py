"""Ground-state search on chimera droplet instances
(the port of tnax's ``examples/e01_search_gs.py``, reference
`examples/e01_search_gs_droplet_instances.py`)."""

import argparse
import logging
import time

from ..solver import Solver
from .common import (CHIMERA_SHAPES, add_device_argument,
                     load_droplet_instance)


def search_gs_droplet(L=128, instance=1, rot=0, beta=3, D=48, M=1024,
                      relative_P_cutoff=1e-8, precondition=True, path="host",
                      device=None):
    Nx, Ny, Nc = CHIMERA_SHAPES[L]
    J = load_droplet_instance(L, instance)
    ins = Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, J=J, beta=beta,
                 device=device)
    ins.logger.info("Analysing droplet instance %d on chimera-%d", instance, L)
    if rot > 0:
        ins.rotate_graph(rot=rot)
    if precondition:
        ins.precondition(mode="balancing")
    ins.search_ground_state(M=M, relative_P_cutoff=relative_P_cutoff,
                            Dmax=D, path=path)
    return ins


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-L", type=int, choices=[128, 512, 1152, 2048], default=128)
    p.add_argument("-ins", type=int, default=1)
    p.add_argument("-r", type=int, default=0, help="rotations")
    p.add_argument("-b", type=float, default=3, help="inverse temperature")
    p.add_argument("-D", type=int, default=48, help="boundary-MPS bond dim")
    p.add_argument("-M", type=int, default=2 ** 10, help="beam width")
    p.add_argument("-P", type=float, default=1e-8, help="relative P cutoff")
    p.add_argument("-path", choices=["host", "device"], default="host",
                   help="beam bookkeeping: exact host or device-resident")
    p.add_argument("-no-pre", dest="pre", action="store_false")
    add_device_argument(p)
    p.set_defaults(pre=True)
    args = p.parse_args()

    logging.basicConfig(level="INFO")
    t0 = time.time()
    ins = search_gs_droplet(L=args.L, instance=args.ins, rot=args.r,
                            beta=args.b, D=args.D, M=args.M,
                            relative_P_cutoff=args.P, precondition=args.pre,
                            path=args.path, device=args.device)
    ins.logger.info("Total time : %.2f seconds", time.time() - t0)
    ins.show_solution()
    print("Solution [1 -> spin up; 0 -> spin down]:")
    print(ins.binary_states())
