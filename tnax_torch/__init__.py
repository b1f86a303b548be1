"""tnax_torch — the PyTorch/CUDA port of tnax for one NVIDIA H100.

tnax (JAX, beside this package) is the reference; this package imports
torch, numpy and scipy, never jax or tnax. Module and function names
follow tnax's so that each counterpart can be found. The ``Solver`` takes
tnax's arguments and methods: the ground-state search, Gibbs sampling and
the low-energy spectrum, each on tnax's two paths (``path="host"``, the
default, with exact host bookkeeping; ``path="device"``, all on the
device), the balancing preconditioner (its 'ud' sweeps on either path,
'lr' on the host), Ising and RMF problems, and ``save``/``load``::

    import numpy as np, tnax_torch as tt
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=16, Ny=16, Nc=8, J=J, beta=3)
    ins.precondition()      # or (path="host", directions=("ud", "lr"))
    ins.search_ground_state(M=1024, relative_P_cutoff=1e-8, Dmax=32)
    ins.energy, ins.degeneracy, ins.binary_states()
    ins.gibbs_sampling(M=128, Dmax=48, seed=0)      # ins.energy, ins.states
    np.random.seed(7)
    ins.add_noise(1e-7)
    ins.search_low_energy_spectrum(excitations_encoding=2, M=1024,
                                   relative_P_cutoff=1e-8, Dmax=32,
                                   max_dEng=1.0, path="device",
                                   cand_factor=64)
    ins.decode_low_energy_states(max_dEng=1.0)
    ins.save("result.npy")
    same = tt.load("result.npy")

The boundary-MPS layer is tnax's too (``tnax_torch.bmps``: the MPS API
of ``init_mps``, ``canonize_left``/``canonize_right``, ``compress``,
``apply_mpo``, the expectation values and measurements, ``mps_dot``;
``tnax_torch.engine``: the four stack functions ``build_rhoT/B/L/R``,
zip-up or fat), and so are the preconditioner's named functions
(``tnax_torch.precondition``: ``balance_ud``, ``balance_lr``,
``balance_ud_device``, ``precondition_ladder_device``,
``precondition_fleet``); ``tnax_torch.interop`` carries tnax's arrays
across.

Fleets of same-shape instances run through one batch axis: the context
functions (``parallel.multi_search_gs``, ``parallel.multi_sample``,
``multi_search_spectrum``) and the flagship pipelines (the balancing
ladder, the boundary and the search or sampling pass in one call,
``parallel.flagship_search_gs``, ``flagship_sample`` and their ``multi_``
forms).

tnax's device mesh runs on ``torch.distributed``, one process per rank
(``tnax_torch.mesh``; ``parallel.make_mesh``): 'data' shards a fleet's
instances (``mesh=`` of ``parallel.multi_search_gs`` and
``multi_flagship_sample``), 'beam' the branches of one search
(``parallel.sharded_search_gs``, ``spectrum.sharded_search_spectrum``).
``tnax_torch.profiling`` traces with ``torch.profiler`` and times phases;
the ``"tnax_torch"`` logger reports each row; ``tnax_torch.examples``
holds tnax's example scripts e01-e07.

Solvers run on CUDA in float32 unless given ``device`` and ``dtype``
(``device="cpu"`` runs the plain versions in float64). Four device
functions are hand-written CUDA C++ kernels (``tnax_torch.kernels``): K1
the balancing scales, K2 the beam-merge segments, K3 the marginal
epilogue and K4 the sampler's whole site step (``sample_site``). They
build with nvcc at first use on a CUDA tensor. The spectrum's droplet
store runs on the host, its hot loops in C (``tnax_torch.native``, built
with the system C compiler at first use).
"""

from . import (bmps, config, engine, interop, parallel, precondition,
               sample, search, spectrum)
from .parallel import flagship_sample, multi_flagship_sample
from .spectrum import multi_search_spectrum
from .problems import (Jij_f2p, energy_Jij, energy_RMF, load_Jij,
                       minus_Jij, round_Jij)
from .solver import Solver, load, tnac4o

__all__ = ["Solver", "tnac4o", "load", "parallel", "config", "sample",
           "search", "spectrum", "bmps", "engine", "precondition", "interop",
           "flagship_sample", "multi_flagship_sample",
           "multi_search_spectrum", "load_Jij", "round_Jij", "minus_Jij",
           "Jij_f2p", "energy_Jij", "energy_RMF"]

__version__ = "0.5.0"
