"""Fleet sweep: batched ground-state search over many instances, one
batch of same-shape instances per call (the port of tnax's
``examples/e07_fleet_sweep.py``; the reference has no parallel execution,
its production pattern is one shell process per instance).

``parallel.multi_flagship_search_gs`` runs the whole pipeline (the
balancing beta ladder, the gauged PEPS rows, the boundary-MPS stack and
the beam search) once for a batch, every stage with a leading instance
axis, so the batch shares every launch.
"""

import argparse
import logging
import time

import numpy as np

from .. import parallel, problems
from ..solver import Solver
from .common import (CHIMERA_SHAPES, add_device_argument,
                     load_droplet_instance)


def fleet_sweep(L=512, first=1, n=16, batch=8, beta=3, D=32, M=1024,
                relative_P_cutoff=1e-8, cand_factor=8, device=None):
    Nx, Ny, Nc = CHIMERA_SHAPES[L]
    t0 = time.time()
    energies = {}
    ids = list(range(first, first + n))
    for lo in range(0, len(ids), batch):
        group = ids[lo:lo + batch]
        # pad the final partial batch so every batch has one shape
        padded = group + [group[-1]] * (batch - len(group))
        Js = {k: load_droplet_instance(L, k) for k in set(padded)}
        solvers = [Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, J=Js[k],
                          beta=beta, device=device) for k in padded]
        results = parallel.multi_flagship_search_gs(
            solvers, M=M, relative_P_cutoff=relative_P_cutoff, Dmax=D,
            cand_factor=cand_factor)
        for k, ins, r in zip(group, solvers, results):
            # exact host-side energy of the returned state
            ins.states = np.asarray(r["states"])[None, :][:, ins.order]
            energies[k] = float(problems.energy_Jij(
                Js[k], ins.binary_states())[0])
            logging.info("instance %3d: E = %.8f  (deg %d, overflow %d)",
                         k, energies[k], r["degeneracy"],
                         r["merge_overflow"])
    dt = time.time() - t0
    logging.info("%d instances in %.1f s = %.1f instances/min",
                 n, dt, 60.0 * n / dt)
    return energies


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser()
    p.add_argument("-L", type=int, choices=[128, 512, 1152, 2048],
                   default=512)
    p.add_argument("-first", type=int, default=1,
                   help="first instance number (default 1)")
    p.add_argument("-n", type=int, default=16,
                   help="number of instances (default 16)")
    p.add_argument("-batch", type=int, default=8,
                   help="instances per batch (default 8)")
    p.add_argument("-b", type=float, default=3)
    p.add_argument("-D", type=int, default=32)
    p.add_argument("-M", type=int, default=2 ** 10)
    p.add_argument("-P", type=float, default=1e-8)
    add_device_argument(p)
    args = p.parse_args()
    fleet_sweep(L=args.L, first=args.first, n=args.n, batch=args.batch,
                beta=args.b, D=args.D, M=args.M,
                relative_P_cutoff=args.P, device=args.device)
