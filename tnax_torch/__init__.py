"""tnax_torch — the PyTorch/CUDA port of tnax for one NVIDIA H100.

tnax (JAX, beside this package) is the reference; this package imports
torch, numpy and scipy, never jax or tnax. Module and function names
follow tnax's so that each counterpart can be found. The slices ported
so far are the flagship ground-state search, Gibbs sampling and the
low-energy spectrum, each for one instance and for a fleet, which runs
many same-shape instances through one batch axis::

    import torch, tnax_torch as tt
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=16, Ny=16, Nc=8, J=J, beta=3)
    res = tt.parallel.flagship_search_gs(ins, M=1024,
                                         relative_P_cutoff=1e-8, Dmax=32)
    solvers = [tt.Solver(mode="Ising", Nx=8, Ny=8, Nc=8, J=J_b, beta=3)
               for J_b in Js]
    rs = tt.parallel.multi_flagship_search_gs(
        solvers, M=1024, relative_P_cutoff=1e-8, Dmax=32, cand_factor=2)
    smp = tt.flagship_sample(ins, M=128, Dmax=48, pre_steps=2, seed=0)
    smps = tt.multi_flagship_sample(solvers, M=128, Dmax=48, pre_steps=2)
    # the low-energy spectrum: droplets recorded on the device, replayed
    # and decoded on the host
    import numpy as np
    np.random.seed(7)
    ins.add_noise(1e-7)
    ins.precondition()
    ins.search_low_energy_spectrum(excitations_encoding=2, M=1024,
                                   relative_P_cutoff=1e-8, Dmax=32,
                                   max_dEng=1.0, cand_factor=64)
    ins.decode_low_energy_states(max_dEng=1.0)   # ins.energy, ins.states

Solvers run on CUDA in float32 unless given ``device`` and ``dtype``
(``device="cpu"`` runs the plain versions in float64). Four device
functions are hand-written CUDA C++ kernels (``tnax_torch.kernels``): K1
the balancing scales, K2 the beam-merge segments, K3 the marginal
epilogue and K4 the sampler's whole site step (``sample_site``). They
build with nvcc at first use on a CUDA tensor. The spectrum's droplet
store runs on the host, its hot loops in C (``tnax_torch.native``, built
with the system C compiler at first use).
"""

from . import config, parallel, search, spectrum
from .parallel import flagship_sample, multi_flagship_sample
from .spectrum import multi_search_spectrum
from .problems import (Jij_f2p, energy_Jij, load_Jij, minus_Jij,
                       round_Jij)
from .solver import Solver

__all__ = ["Solver", "parallel", "config", "search", "spectrum",
           "flagship_sample", "multi_flagship_sample",
           "multi_search_spectrum", "load_Jij", "round_Jij", "minus_Jij",
           "Jij_f2p", "energy_Jij"]

__version__ = "0.4.0"
