"""Solver facade mirroring tnax's public API (``tnax.Solver``, alias
``tnac4o``).

The constructor (Ising or RMF, with an explicit ``device`` and
``dtype``), rotations, noise, the contraction context, the balancing
preconditioner (its 'ud' direction on both of tnax's paths, 'lr' on the
host), the ground-state search and Gibbs sampling on both of tnax's
paths (``path="host"``, the default: exact float64 beam bookkeeping or
NumPy random numbers on the host, one device read per site;
``path="device"``: the whole search or sampling pass on the device), the
low-energy spectrum on both paths and its decoding, the found ``states``
decoded to spin bit-strings, ``save`` and the module-level :func:`load`
(the reference's ``.npy`` format), and the ``show_*`` displays.
"""

from __future__ import annotations

import logging

import numpy as np

from . import config
from . import parallel as _par
from . import precondition as _pre
from . import sample as _sample
from . import search as _search
from . import spectrum as _spec
from .problems import IsingProblem, RMFProblem, block_bits

logger = logging.getLogger("tnax_torch")


class Solver:
    """Tensor-network solver for quasi-2D Ising and RMF problems.

    Args mirror tnax's: mode ('Ising' or 'RMF'), Nx, Ny, Nc (lattice
    shape, Nc spins per block, Ising only), beta (inverse temperature of
    the Gibbs PEPS), J ([[i, j, Jij], ...], 0-based, for Ising; the factor
    dict for RMF; None: a solver without a problem, which can hold and
    decode results, as ``load`` makes, but not search). ``device`` and
    ``dtype`` set where and in which float type the contractions run: by
    default CUDA in float32 (RuntimeError where there is no CUDA card);
    pass ``device="cpu"`` for the CPU, where the default is float64.
    """

    def __init__(self, mode="Ising", Nx=4, Ny=4, Nc=8, beta=1, J=None,
                 device=None, dtype=None):
        if mode not in ("Ising", "RMF"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device, self.dtype = config.resolve(device, dtype)
        self.mode = mode
        self.beta = beta
        self.Nx_model, self.Ny_model = Nx, Ny
        self.Nc = Nc if mode == "Ising" else 1
        self.L = Nx * Ny * self.Nc
        self.logger = logger
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
        self.problem = None
        self._gauges = None
        if J is None:
            return
        if mode == "Ising":
            self.problem = IsingProblem(Nx=Nx, Ny=Ny, Nc=Nc, J=J)
            self.J = self.problem.J
            self.J0 = self.problem.J.copy()
            self.ind0 = [[self.problem.ind[ny][nx] for nx in range(Nx)]
                         for ny in range(Ny)]
        else:
            self.problem = RMFProblem(Nx=Nx, Ny=Ny, J=J)
            self.J = self.problem.J
            self.ind0 = []

    @property
    def Nx(self):
        return self.problem.Nx if self.problem else self.Nx_model

    @property
    def Ny(self):
        return self.problem.Ny if self.problem else self.Ny_model

    def rotate_graph(self, rot=1):
        """Cumulative 90-degree rotations (reference
        `tnac4o/tnac4o.py:290-340`); the gauges go back to the identity."""
        for _ in range(rot):
            self.rotation = (self.rotation + 1) % 4
            order_i = self.problem.rotate()
            self.order = order_i[self.order]
        self.order_i[self.order] = np.arange(self.Nx * self.Ny)
        if self.mode == "Ising":
            self.J = self.problem.J
        self._gauges = None

    def add_noise(self, amplitude=1e-7, rng=None):
        """Uniform noise on the nonzero couplings to lift accidental
        degeneracies (reference `tnac4o/tnac4o.py:917-941`). ``rng=None``
        draws from the global legacy NumPy RNG, as tnax and the reference
        do, so ``np.random.seed(s)`` gives tnax's couplings."""
        logger.info("Adding noise with amplitude %.2e", amplitude)
        self.problem.add_noise(amplitude, rng=rng)
        if self.mode == "Ising":
            self.J = self.problem.J
        self._gauges = None

    def _context(self):
        """The contraction context of this instance at its beta and
        gauges (a batch of one); the gauges start as the identity."""
        if self.problem is None:
            raise ValueError("no couplings: construct the solver with J=... "
                             "before searching or sampling (reference "
                             "tnac4o.py:174)")
        ctx = _search.ContractionContext(self, gauges=self._gauges)
        self._gauges = ctx.gauges
        return ctx

    def precondition(self, mode="balancing", steps=2, beta_cond=None,
                     Dmax_cond=None, max_scale=1024,
                     graduate_truncation=False, tolS=1e-16, tolV=1e-10,
                     max_sweeps=20, directions=("ud",), path=None,
                     omega=None, stage_times=None):
        """Balancing preconditioner (reference `tnac4o/tnac4o.py:342-379`)
        from the current gauges, at the rungs ``beta_cond`` (default
        beta * 2**(n - steps)) with boundary bonds ``Dmax_cond`` (default
        8). On each rung the ``directions`` run in the order given: 'ud'
        on ``path`` and 'lr' on the host. ``path="host"`` builds each
        rung's boundary stacks on the device and sweeps them on the host
        in float64 (``precondition.ud_host``, tnax's ``balance_ud``);
        ``path="device"`` runs the 'ud' sweeps on the device as well
        (``precondition._ladder_program``, kernel K1 on CUDA); None takes
        tnax's default for the solver's device: the host on the CPU, the
        device on CUDA. 'lr' is tnax's ``balance_lr``
        (``precondition.lr_host``). Sets the gauges and ``overlaps_ud``
        (two rows per 'ud' sweep, tnax's). ``omega`` is the zip-up's
        sketch (``graduate_truncation`` has no effect on it);
        ``stage_times``, if a dict, receives the seconds of the
        device ladder ("ladder", with each rung's sub-spans "ladder/peps",
        "ladder/build" and "ladder/balance") or of the host path's builds
        and sweeps ("ud builds", "ud sweeps", "lr builds", "lr sweeps"),
        each ended by a synchronize, and their counters
        (``config.StageClock``).
        """
        if mode != "balancing":
            raise ValueError("only mode='balancing' is implemented")
        if path is None:
            path = "host" if self.device.type == "cpu" else "device"
        if path not in ("host", "device"):
            raise ValueError(f"path must be 'host' or 'device', got {path!r}")
        for direction in directions:
            if direction not in ("ud", "lr"):
                raise ValueError(f"directions are 'ud' and 'lr', got "
                                 f"{direction!r}")
        if not beta_cond:
            beta_cond = _pre.ladder_betas(self.beta, steps)
        if not Dmax_cond:
            Dmax_cond = [8] * len(beta_cond)
        with config.StageClock(stage_times, self.device) as clock:
            ctx = self._context()
            f = ctx.tables
            X, overlaps = ctx.gauges, []
            ms = _pre.ladder_max_scale(max_scale)
            kw = dict(tolS=tolS, tolV=tolV, max_sweeps=max_sweeps, omega=omega)
            if path == "device":
                logger.info("Preconditioning ladder (device): betas %s",
                            [round(b, 3) for b in beta_cond])
            for beta, D in zip(beta_cond, Dmax_cond):
                logger.info("Preconditioning with beta = %.2f", beta)
                for direction in directions:
                    if direction == "lr":
                        X = _pre.lr_host(f, beta, X, Dmax=D, max_scale=ms,
                                         clock=clock, **kw)
                    elif path == "host":
                        X, o = _pre.ud_host(f, beta, X, Dmax=D, max_scale=ms,
                                            clock=clock, **kw)
                        overlaps.append(o[0])
                    else:
                        X, o = _pre._ladder_program(
                            f["Es"], f["Esl"], f["Esu"], f["dmap"], f["rmap"],
                            X, [beta], f["ndall"], ms, Dmax=D, lh=f["lh"],
                            lv=f["lv"], **kw)
                        clock.lap("ladder")
                        overlaps.append(_pre.overlaps_ud(_pre._host64(o[0])))
        self._gauges = X
        # worst-case mixed overlaps per interface, one row pair per sweep
        self.overlaps_ud = np.vstack(overlaps) if overlaps \
            else np.empty((0, max(self.Ny - 1, 0)))

    def search_ground_state(self, M=2 ** 10, relative_P_cutoff=1e-6,
                            min_dEng=1e-12, graduate_truncation=True,
                            Dmax=32, tolS=1e-16, tolV=1e-10, max_sweeps=20,
                            path="host", cand_factor=8, omega=None,
                            stage_times=None):
        """Branch-and-bound most-probable-state search (reference
        `tnac4o/tnac4o.py:381-551`). Returns the lowest energy found.

        ``path="host"`` (the default) keeps the reference's exact float64
        beam bookkeeping (``search.search_ground_state``: per site the
        device computes the marginals, kernel K3 on CUDA, and the host
        reads them once); ``path="device"`` runs the whole beam search on
        the device (``parallel.device_search_gs``, kernels K2 and K3),
        whose merge candidate set is capped at ``cand_factor`` * M (None:
        the full M*Np expansion); its energy is recomputed exactly on the
        host, and its ties resolve at the compute dtype's precision.
        ``omega`` is the boundary's zip-up sketch; ``stage_times``, if a
        dict, receives the seconds of the boundary and of the search.
        """
        ctx = self._context()
        kw = dict(M=M, relative_P_cutoff=relative_P_cutoff,
                  min_dEng=min_dEng, Dmax=Dmax, tolS=tolS, tolV=tolV,
                  max_sweeps=max_sweeps,
                  graduate_truncation=graduate_truncation, omega=omega,
                  stage_times=stage_times)
        if path == "device":
            r = _par.device_search_gs(ctx, cand_factor=cand_factor, **kw)
            states = r["states"][None, :]
            self.set_result(_search.SearchResult(
                energy=_par.exact_energies(ctx, states),
                probability=np.array([r["prob"]]),
                degeneracy=r["degeneracy"], states=states,
                discarded_probability=r["discarded_probability"],
                negative_probability=r["negative_probability"],
                merge_overflow=r["merge_overflow"], count_max=r["count_max"],
                negative_probability_core=r["negative_probability_core"]))
            return self.energy
        if path != "host":
            raise ValueError(f"path must be 'host' or 'device', got {path!r}")
        self.set_result(_search.search_ground_state(ctx, **kw))
        return self.energy

    def gibbs_sampling(self, M=2 ** 10, graduate_truncation=True, Dmax=32,
                       tolS=1e-15, tolV=1e-10, max_sweeps=20, seed=None,
                       path="host", omega=None, stage_times=None):
        """Sample M configurations from the Gibbs distribution (reference
        `tnac4o/tnac4o.py:553-650`). Returns the sampled energies (exact
        float64).

        ``path="host"`` (the default) draws the random numbers from a
        NumPy generator seeded with ``seed`` (None: unseeded), in tnax's
        order (``sample.gibbs_sampling``); ``path="device"`` draws them on
        the device from ``seed or 0`` (``parallel.device_sample``). Both
        run the sampling pass on the device, kernel K4 for each site step
        on CUDA. ``omega`` is the boundary's zip-up sketch;
        ``stage_times``, if a dict, receives the seconds of the boundary
        and of the pass.
        """
        ctx = self._context()
        kw = dict(M=M, Dmax=Dmax, tolS=tolS, tolV=tolV,
                  max_sweeps=max_sweeps,
                  graduate_truncation=graduate_truncation, omega=omega,
                  stage_times=stage_times)
        if path == "device":
            r = _par.device_sample(ctx, seed=seed or 0, **kw)
            res = _sample.SampleResult(
                energy=r["energy"], states=r["states"],
                negative_probability=r["negative_probability"])
        elif path == "host":
            res = _sample.gibbs_sampling(
                ctx, rng=np.random.default_rng(seed)
                if seed is not None else None, **kw)
        else:
            raise ValueError(f"path must be 'host' or 'device', got {path!r}")
        self.energy = res.energy
        self.probability = np.zeros(1)
        self.degeneracy = 0
        self.states = res.states[:, self.order]
        self.discarded_probability = 0
        self.negative_probability = res.negative_probability
        return self.energy

    def search_low_energy_spectrum(self, excitations_encoding=1, M=2 ** 10,
                                   relative_P_cutoff=1e-6, max_dEng=0.0,
                                   lim_hd=0, min_dEng=1e-12,
                                   graduate_truncation=True, Dmax=32,
                                   tolS=1e-16, tolV=1e-10, max_sweeps=20,
                                   path="host", cand_factor=8,
                                   auto_grow=True, zipup_rsvd=None,
                                   omega=None, native=True,
                                   stage_times=None):
        """Low-energy spectrum search recording droplet structure
        (reference `tnac4o/tnac4o.py:652-725`). Returns the energies.

        ``path="host"`` (the default) keeps the reference's exact beam
        bookkeeping with one device read per site
        (``spectrum.search_spectrum``); every candidate of every merge is
        recorded, so ``cand_factor`` and ``auto_grow`` do not apply.
        ``path="device"`` runs each lattice row on the device, which
        emits decision records that the host replays into exact float64
        energies, states, degeneracies and droplet trees
        (``spectrum.device_search_spectrum``); ``cand_factor`` caps the
        per-site merge candidates at cand_factor*M (None: the full M*Np
        expansion). If the cap is ever exceeded and ``auto_grow`` is set,
        the search runs again with the cap grown as tnax grows it (twice
        the measured need, rounded up to a power of two, at most the full
        expansion); ``self.merge_overflow`` reports the residual overflow
        (0: the droplet records are complete), ``self.cand_factor`` the
        last cap and ``self.spectrum_passes`` each pass's (cand_factor,
        merge_overflow, count_max). ``zipup_rsvd`` and ``omega`` set the
        boundary's zip-up, ``native`` the droplet store's C code (else its
        NumPy versions); ``stage_times``, if a dict, receives the seconds
        of the boundary and of the search (host), or of the boundary, the
        records and the replay (device).
        """
        ctx = self._context()
        self.excitations_encoding = excitations_encoding
        kw = dict(M=M, relative_P_cutoff=relative_P_cutoff,
                  max_dEng=max_dEng, lim_hd=lim_hd, min_dEng=min_dEng,
                  Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
                  graduate_truncation=graduate_truncation,
                  zipup_rsvd=zipup_rsvd, omega=omega, native=native,
                  stage_times=stage_times)
        if path == "host":
            self.set_result(_spec.search_spectrum(
                self, ctx, excitations_encoding, **kw))
            return self.energy
        if path != "device":
            raise ValueError(f"path must be 'host' or 'device', got {path!r}")
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
        """Take a search's result (``search.SearchResult``) as this
        solver's, its states in the solver's cluster order."""
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
        """States as spin bit-strings: 1=up, 0=down, 2=inactive
        (reference `tnac4o/tnac4o.py:261-288`); RMF states as they are."""
        ns = self.states.shape[0]
        ns = ns + number + 1 if number < 0 else min(number, ns)
        if self.mode != "Ising":
            return self.states[:ns]
        if self.problem is None:
            return _decode_from_ind0(self.states[:ns], self.ind0, self.L)
        return self.problem.decode_states(self.states[:ns], self.ind0,
                                          self.L)

    def save(self, file_name):
        """Save the results in the reference's .npy dict format
        (`tnac4o/tnac4o.py:200-233`): files round-trip with tnax and the
        reference."""
        d = {
            "mode": self.mode, "rotation": self.rotation,
            "energy": self.energy, "probability": self.probability,
            "degeneracy": self.degeneracy, "states": self.states,
            "discarded_probability": self.discarded_probability,
            "negative_probability": self.negative_probability,
            "negative_probability_core": self.negative_probability_core,
            "Nx": self.Nx_model, "Ny": self.Ny_model, "Nc": self.Nc,
            "beta": self.beta,
        }
        if self.mode == "Ising":
            d["ind"] = self.ind0
        if hasattr(self, "excitations_encoding"):
            d["excitations_encoding"] = self.excitations_encoding
            d["d"] = self.d
            d["invd"] = self.invd
            d["el"] = self.el
            d["free_d"] = self.free_d
            if self.excitations_encoding > 1 and self.mode == "Ising":
                import scipy.sparse
                d["adj"] = scipy.sparse.csr_matrix(self.adj)
        np.save(file_name, d)

    def show_properties(self):
        print("L:     ", self.L)
        print("Ny:    ", self.Ny)
        print("Nx:    ", self.Nx)
        print("Beta:  ", self.beta)

    def show_solution(self, state=False):
        if len(self.energy) > 0:
            print("Energy            : %4.6f" % self.energy[0])
            print("Degeneracy        : %2d" % self.degeneracy)
            print("log2(Probability) : %0.2e" % self.probability[0])
            print("Discarder log2(P) : %0.2e" % self.discarded_probability)
            print("Min P (err)       : %0.2e" % self.negative_probability)
            print("Min P (core)      : %0.2e"
                  % self.negative_probability_core)
            print("# of states       : %1d" % len(self.energy))
            print("Rotation/direction: %1d" % self.rotation)
            if state:
                print(self.states[0])
        else:
            print("No solution to show.")

    def exc_print(self):
        _spec.exc_print(self)


def _decode_from_ind0(states, ind0, L):
    """Ising bit-strings of ``states`` from the active-spin ids ``ind0``
    alone, for a solver without a problem (tnax solver.py:416-429)."""
    ns = states.shape[0]
    out = np.full((ns, L), 2, dtype=np.int8)
    kk = -1
    for row in ind0:
        for act in row:
            kk += 1
            act = np.asarray(act)
            if act.size == 0:
                continue
            conf = 1 - block_bits(len(act))
            out[:, act] = conf[states[:ns, kk]]
    return out


def load(file_name, device=None, dtype=None):
    """Load a result saved by :meth:`Solver.save`, tnax's or the
    reference's (reference `load`, `tnac4o/tnac4o.py:31-75`), into a
    solver without a problem on ``device`` (see :class:`Solver`).

    .. warning::
        The format is a pickled dict inside ``.npy`` (the reference's), and
        unpickling runs arbitrary code: load result files from trusted
        sources only.
    """
    d = np.load(file_name, allow_pickle=True).item()
    ins = Solver(mode=d["mode"], Nx=d["Nx"], Ny=d["Ny"], Nc=d["Nc"],
                 beta=d["beta"], device=device, dtype=dtype)
    ins.energy = d["energy"]
    ins.probability = d["probability"]
    ins.degeneracy = d["degeneracy"]
    ins.states = d["states"]
    ins.discarded_probability = d["discarded_probability"]
    ins.negative_probability = d["negative_probability"]
    # absent in files written by the reference (raw flag only there)
    ins.negative_probability_core = d.get("negative_probability_core", 0.0)
    if d["mode"] == "Ising":
        ins.ind0 = d.get("ind")
    if "excitations_encoding" in d:
        ins.excitations_encoding = d["excitations_encoding"]
        ins.d = d["d"]
        ins.invd = d["invd"]
        ins.el = d["el"]
        ins.free_d = d["free_d"]
        if ins.excitations_encoding > 1:
            _spec.reset_adjacency_from_saved(ins, d.get("adj"))
    return ins


# the reference's name
tnac4o = Solver
