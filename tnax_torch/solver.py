"""Solver facade: the part of ``tnax.Solver`` that the flagship search needs.

The Ising constructor (with an explicit ``device`` and ``dtype``), the
cluster order, the found ``states`` and their decoding to spin
bit-strings. Rotations, noise, RMF, the host search paths, sampling, the
spectrum and save/load are not ported yet.
"""

from __future__ import annotations

import numpy as np

from . import config
from .problems import IsingProblem


class Solver:
    """Tensor-network solver for quasi-2D Ising problems.

    Args mirror tnax's: mode ('Ising' only so far), Nx, Ny, Nc (lattice
    shape, Nc spins per block), beta (inverse temperature of the Gibbs
    PEPS), J ([[i, j, Jij], ...], 0-based). ``device`` and ``dtype`` set
    where and in which float type the contractions run (default: CPU
    float64; CUDA float32).
    """

    def __init__(self, mode="Ising", Nx=4, Ny=4, Nc=8, beta=1, J=None,
                 device=None, dtype=None):
        if mode != "Ising":
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        if J is None:
            raise ValueError("construct the solver with couplings J=...")
        self.device, self.dtype = config.resolve(device, dtype)
        self.beta = beta
        self.L = Nx * Ny * Nc
        self.order = np.arange(Nx * Ny)   # cluster order (no rotations yet)
        self.states = np.zeros((0, Nx * Ny), dtype=np.int32)
        self.problem = IsingProblem(Nx=Nx, Ny=Ny, Nc=Nc, J=J)
        self.ind0 = [[self.problem.ind[ny][nx] for nx in range(Nx)]
                     for ny in range(Ny)]

    def binary_states(self, number=-1):
        """States as spin bit-strings: 1=up, 0=down, 2=inactive."""
        ns = self.states.shape[0]
        ns = ns + number + 1 if number < 0 else min(number, ns)
        return self.problem.decode_states(self.states[:ns], self.ind0,
                                          self.L)
