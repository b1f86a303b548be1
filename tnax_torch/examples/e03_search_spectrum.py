"""Low-energy spectrum search + droplet storage
(the port of tnax's ``examples/e03_search_spectrum.py``, reference
`examples/e03_search_spectrum_droplet_instances.py`)."""

import argparse
import logging
import os
import time

from ..solver import Solver
from .common import (CHIMERA_SHAPES, add_device_argument,
                     load_droplet_instance)


def search_spectrum_droplet(L=128, instance=1, rot=0, beta=3, D=48, M=1024,
                            relative_P_cutoff=1e-8, excitations_encoding=1,
                            dE=1.0, hd=0, precondition=True, path="host",
                            device=None):
    Nx, Ny, Nc = CHIMERA_SHAPES[L]
    J = load_droplet_instance(L, instance)
    ins = Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, J=J, beta=beta,
                 device=device)
    if rot > 0:
        ins.rotate_graph(rot=rot)
    if excitations_encoding > 1:
        ins.add_noise(amplitude=1e-7)
    if precondition:
        ins.precondition(mode="balancing")
    ins.search_low_energy_spectrum(
        excitations_encoding=excitations_encoding, M=M,
        relative_P_cutoff=relative_P_cutoff, Dmax=D, max_dEng=dE,
        lim_hd=hd, path=path)
    return ins


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("-L", type=int, choices=[128, 512, 1152, 2048], default=128)
    p.add_argument("-ins", type=int, default=1)
    p.add_argument("-r", type=int, default=0)
    p.add_argument("-b", type=float, default=3)
    p.add_argument("-D", type=int, default=48)
    p.add_argument("-M", type=int, default=2 ** 10)
    p.add_argument("-P", type=float, default=1e-8)
    p.add_argument("-dE", type=float, default=1.0)
    p.add_argument("-hd", type=int, default=0)
    p.add_argument("-ee", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("-s", dest="save", action="store_true",
                   help="save result to .npy")
    p.add_argument("-path", choices=["host", "device"], default="host",
                   help="beam bookkeeping: exact host or device-resident")
    p.add_argument("-no-pre", dest="pre", action="store_false")
    add_device_argument(p)
    p.set_defaults(pre=True, save=False)
    args = p.parse_args()

    logging.basicConfig(level="INFO")
    t0 = time.time()
    ins = search_spectrum_droplet(
        L=args.L, instance=args.ins, rot=args.r, beta=args.b, D=args.D,
        M=args.M, relative_P_cutoff=args.P,
        excitations_encoding=args.ee, dE=args.dE, hd=args.hd,
        precondition=args.pre, path=args.path, device=args.device)
    ins.logger.info("Total time : %.2f seconds", time.time() - t0)
    ins.show_solution()
    if args.save:
        name = ("./results/sol_L=%d_ins=%03d_r=%d_b=%1.2f_M=%d_D=%d_ee=%d"
                % (args.L, args.ins, args.r, args.b, args.M, args.D, args.ee))
        os.makedirs("./results", exist_ok=True)
        ins.save(name + ".npy")
        print("saved to", name + ".npy")
