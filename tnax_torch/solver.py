"""Solver facade: the part of ``tnax.Solver`` that the port runs.

The Ising constructor (with an explicit ``device`` and ``dtype``),
rotations, noise, the contraction context, the balancing preconditioner
on the device, the device-record low-energy spectrum and its decoding,
and the found ``states`` decoded to spin bit-strings. RMF, the host search
paths (``path="host"``), the Solver's own ground-state search and Gibbs
sampling methods, and save/load are not ported yet; the flagship search
and sampling are reachable through ``parallel``.
"""

from __future__ import annotations

import logging

import numpy as np

from . import config
from . import parallel as _par
from . import precondition as _pre
from . import search as _search
from . import spectrum as _spec
from .problems import IsingProblem

logger = logging.getLogger("tnax_torch")


class Solver:
    """Tensor-network solver for quasi-2D Ising problems.

    Args mirror tnax's: mode ('Ising' only so far), Nx, Ny, Nc (lattice
    shape, Nc spins per block), beta (inverse temperature of the Gibbs
    PEPS), J ([[i, j, Jij], ...], 0-based). ``device`` and ``dtype`` set
    where and in which float type the contractions run: by default CUDA
    in float32 (RuntimeError where there is no CUDA card); pass
    ``device="cpu"`` for the CPU, where the default is float64.
    """

    def __init__(self, mode="Ising", Nx=4, Ny=4, Nc=8, beta=1, J=None,
                 device=None, dtype=None):
        if mode != "Ising":
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        if J is None:
            raise ValueError("construct the solver with couplings J=...")
        self.device, self.dtype = config.resolve(device, dtype)
        self.mode = mode
        self.beta = beta
        self.Nx_model, self.Ny_model, self.Nc = Nx, Ny, Nc
        self.L = Nx * Ny * Nc
        self.rotation = 0
        self.order = np.arange(Nx * Ny)     # cluster order
        self.order_i = np.arange(Nx * Ny)   # its inverse
        self.energy = np.zeros(0)
        self.probability = np.zeros(0)
        self.degeneracy = 0
        self.states = np.zeros((0, Nx * Ny), dtype=np.int32)
        self.discarded_probability = 0.0
        self.negative_probability = 0.0
        self.negative_probability_core = 0.0
        self.merge_overflow = 0
        self.count_max = 0
        self.problem = IsingProblem(Nx=Nx, Ny=Ny, Nc=Nc, J=J)
        self.J = self.problem.J
        self.J0 = self.problem.J.copy()
        self.ind0 = [[self.problem.ind[ny][nx] for nx in range(Nx)]
                     for ny in range(Ny)]
        self._gauges = None

    @property
    def Nx(self):
        return self.problem.Nx

    @property
    def Ny(self):
        return self.problem.Ny

    def rotate_graph(self, rot=1):
        """Cumulative 90-degree rotations (reference
        `tnac4o/tnac4o.py:290-340`); the gauges go back to the identity."""
        for _ in range(rot):
            self.rotation = (self.rotation + 1) % 4
            order_i = self.problem.rotate()
            self.order = order_i[self.order]
        self.order_i[self.order] = np.arange(self.Nx * self.Ny)
        self.J = self.problem.J
        self._gauges = None

    def add_noise(self, amplitude=1e-7, rng=None):
        """Uniform noise on the nonzero couplings to lift accidental
        degeneracies (reference `tnac4o/tnac4o.py:917-941`). ``rng=None``
        draws from the global legacy NumPy RNG, as tnax and the reference
        do, so ``np.random.seed(s)`` gives tnax's couplings."""
        logger.info("Adding noise with amplitude %.2e", amplitude)
        self.problem.add_noise(amplitude, rng=rng)
        self.J = self.problem.J
        self._gauges = None

    def _context(self):
        """The contraction context of this instance at its beta and
        gauges (a batch of one); the gauges start as the identity."""
        ctx = _search.ContractionContext(self, gauges=self._gauges)
        self._gauges = ctx.gauges
        return ctx

    def precondition(self, mode="balancing", steps=2, beta_cond=None,
                     Dmax_cond=None, max_scale=1024,
                     graduate_truncation=False, tolS=1e-16, tolV=1e-10,
                     max_sweeps=20, directions=("ud",), path=None,
                     omega=None, stage_times=None):
        """Balancing preconditioner (reference `tnac4o/tnac4o.py:342-379`)
        on the device: the 'ud' beta ladder (``precondition._ladder_program``,
        kernel K1 on CUDA) from the current gauges, at the rungs
        ``beta_cond`` (default beta * 2**(n - steps)) with boundary bonds
        ``Dmax_cond`` (default 8). Sets the gauges and ``overlaps_ud``
        (two rows per rung, tnax's). ``path="host"`` and the 'lr'
        direction are not ported (NotImplementedError). ``omega`` is the
        ladder's zip-up sketch; ``stage_times``, if a dict, receives the
        seconds of the ladder (ended by a synchronize).
        """
        if mode != "balancing":
            raise ValueError("only mode='balancing' is implemented")
        if path not in (None, "device"):
            raise NotImplementedError(f"precondition path {path!r} is not "
                                      f"ported: only the device ladder")
        if tuple(directions) != ("ud",):
            raise NotImplementedError(f"directions {tuple(directions)}: "
                                      f"only ('ud',) is ported")
        if not beta_cond:
            beta_cond = _pre.ladder_betas(self.beta, steps)
        if not Dmax_cond:
            Dmax_cond = [8] * len(beta_cond)
        clock = _par._StageClock(stage_times, self.device)
        ctx = self._context()
        f = ctx.tables
        X, overs = ctx.gauges, []
        for beta, D in zip(beta_cond, Dmax_cond):
            X, o = _pre._ladder_program(
                f["Es"], f["Esl"], f["Esu"], f["dmap"], f["rmap"], X,
                [beta], f["ndall"], _pre.ladder_max_scale(max_scale),
                Dmax=D, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
                lh=f["lh"], lv=f["lv"], omega=omega)
            overs.append(o[0])
        self._gauges = X
        clock.lap("ladder")
        self.overlaps_ud = _pre.overlaps_ud(
            np.concatenate([o.cpu().numpy() for o in overs])) if overs \
            else np.empty((0, max(self.Ny - 1, 0)))

    def search_low_energy_spectrum(self, excitations_encoding=1, M=2 ** 10,
                                   relative_P_cutoff=1e-6, max_dEng=0.0,
                                   lim_hd=0, min_dEng=1e-12,
                                   graduate_truncation=True, Dmax=32,
                                   tolS=1e-16, tolV=1e-10, max_sweeps=20,
                                   path="device", cand_factor=8,
                                   auto_grow=True, zipup_rsvd=None,
                                   omega=None, native=True,
                                   stage_times=None):
        """Low-energy spectrum search recording droplet structure
        (reference `tnac4o/tnac4o.py:652-725`; tnax's ``path="device"``):
        each lattice row runs on the device and emits decision records,
        which the host replays into exact float64 energies, states,
        degeneracies and droplet trees (``spectrum.device_search_spectrum``).
        ``cand_factor`` caps the per-site merge candidates at
        cand_factor*M (None: the full M*Np expansion). If the cap is ever
        exceeded and ``auto_grow`` is set, the search runs again with the
        cap grown as tnax grows it (twice the measured need, rounded up to
        a power of two, at most the full expansion); ``self.merge_overflow``
        reports the residual overflow (0: the droplet records are
        complete), ``self.cand_factor`` the last cap and
        ``self.spectrum_passes`` each pass's (cand_factor, merge_overflow,
        count_max). ``path="host"``
        is not ported (NotImplementedError). ``omega``, ``native`` (the
        droplet store's C code, else its NumPy versions) and
        ``stage_times`` (boundary, records, replay) as in
        ``spectrum.device_search_spectrum``. Returns the energies.
        """
        if path != "device":
            raise NotImplementedError(f"spectrum path {path!r} is not "
                                      f"ported: only path='device'")
        ctx = self._context()
        self.excitations_encoding = excitations_encoding
        kw = dict(M=M, relative_P_cutoff=relative_P_cutoff,
                  max_dEng=max_dEng, lim_hd=lim_hd, min_dEng=min_dEng,
                  Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
                  graduate_truncation=graduate_truncation,
                  zipup_rsvd=zipup_rsvd, omega=omega, native=native,
                  stage_times=stage_times)
        factor = cand_factor
        res = _spec.device_search_spectrum(self, ctx, excitations_encoding,
                                           cand_factor=factor, **kw)
        self.spectrum_passes = [(factor, res.merge_overflow, res.count_max)]
        while auto_grow and res.merge_overflow and factor is not None \
                and factor < ctx.Np:
            # tnax's growth rule (solver.py:311-321): twice the measured
            # need, a power of two, at most the full expansion
            grown = 2 * max(-(-res.count_max // M), factor)
            factor = min(int(ctx.Np), 1 << (grown - 1).bit_length())
            logger.info("merge candidate cap exceeded at %d sites; re-running "
                        "with cand_factor=%d", res.merge_overflow, factor)
            res = _spec.device_search_spectrum(
                self, ctx, excitations_encoding, cand_factor=factor, **kw)
            self.spectrum_passes.append((factor, res.merge_overflow,
                                         res.count_max))
        self.cand_factor = factor
        self.set_result(res)
        return self.energy

    def set_result(self, res):
        """Take a spectrum search's result (``search.SearchResult``) as
        this solver's, its states in the solver's cluster order."""
        self.energy = res.energy
        self.probability = res.probability
        self.degeneracy = res.degeneracy
        self.states = res.states[:, self.order]
        self.discarded_probability = res.discarded_probability
        self.negative_probability = res.negative_probability
        self.negative_probability_core = res.negative_probability_core
        self.merge_overflow = res.merge_overflow
        self.count_max = res.count_max

    def decode_low_energy_states(self, max_dEng=0.0, max_states=1024,
                                 native=True):
        """Expand the droplet tree into explicit low-energy states
        (reference `tnac4o/tnac4o.py:1360-1389`); ``native=False`` runs
        the NumPy versions of the droplet code."""
        self.droplet_native = native
        return _spec.decode_low_energy_states(self, max_dEng=max_dEng,
                                              max_states=max_states)

    def binary_states(self, number=-1):
        """States as spin bit-strings: 1=up, 0=down, 2=inactive."""
        ns = self.states.shape[0]
        ns = ns + number + 1 if number < 0 else min(number, ns)
        return self.problem.decode_states(self.states[:ns], self.ind0,
                                          self.L)
