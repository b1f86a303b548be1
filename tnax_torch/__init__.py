"""tnax_torch — the PyTorch/CUDA port of tnax for one NVIDIA H100.

tnax (JAX, beside this package) is the reference; this package imports
torch, numpy and scipy, never jax or tnax. Module and function names
follow tnax's so that each counterpart can be found. The first slice is
the flagship ground-state search::

    import torch, tnax_torch as tt
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=16, Ny=16, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float32)
    res = tt.parallel.flagship_search_gs(ins, M=1024,
                                         relative_P_cutoff=1e-8, Dmax=32)

Three device functions are hand-written kernels (``tnax_torch.kernels``):
K1 balancing scales and K2 beam-merge segments in CUDA C++, K3 the
marginal epilogue in Triton. They build at first use on a CUDA tensor.
"""

from . import config, parallel
from .problems import (Jij_f2p, energy_Jij, load_Jij, minus_Jij,
                       round_Jij)
from .solver import Solver

__all__ = ["Solver", "parallel", "config", "load_Jij", "round_Jij",
           "minus_Jij", "Jij_f2p", "energy_Jij"]

__version__ = "0.1.0"
