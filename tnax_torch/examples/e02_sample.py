"""Gibbs sampling on chimera droplet instances
(the port of tnax's ``examples/e02_sample.py``, reference
`examples/e02_sample_droplet_instances.py`)."""

import argparse
import logging
import time

from ..solver import Solver
from .common import (CHIMERA_SHAPES, add_device_argument,
                     load_droplet_instance)


def gibbs_sampling(L=128, instance=1, rot=0, beta=3, D=48, M=128,
                   precondition=True, device=None):
    Nx, Ny, Nc = CHIMERA_SHAPES[L]
    J = load_droplet_instance(L, instance)
    ins = Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, J=J, beta=beta,
                 device=device)
    if rot > 0:
        ins.rotate_graph(rot=rot)
    if precondition:
        ins.precondition(mode="balancing")
    ins.gibbs_sampling(M=M, Dmax=D)
    return ins


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-L", type=int, choices=[128, 512, 1152, 2048], default=128)
    p.add_argument("-ins", type=int, default=1)
    p.add_argument("-r", type=int, default=0)
    p.add_argument("-b", type=float, default=3)
    p.add_argument("-D", type=int, default=48)
    p.add_argument("-M", type=int, default=128, help="number of samples")
    p.add_argument("-no-pre", dest="pre", action="store_false")
    add_device_argument(p)
    p.set_defaults(pre=True)
    args = p.parse_args()

    logging.basicConfig(level="INFO")
    t0 = time.time()
    ins = gibbs_sampling(L=args.L, instance=args.ins, rot=args.r, beta=args.b,
                         D=args.D, M=args.M, precondition=args.pre,
                         device=args.device)
    ins.logger.info("Total time : %.2f seconds", time.time() - t0)
    print("Sampled energies:")
    print(ins.energy)
