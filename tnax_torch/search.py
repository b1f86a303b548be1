"""The contraction context: B same-shape problems as device tensors at one
beta and one set of gauges, and their boundary-MPS stack.

Counterpart of ``tnax.search.ContractionContext`` (tnax/search.py:36-103),
with the instance axis B that every core function of the port carries:
one Solver's context is the case B = 1, a fleet's is B instances that
share (Ny, Nx, Np, lh, lv), beta, device and dtype. The flagship
pipelines (``parallel``) build their stacks through this class too, so the
tables, the PEPS rows and the boundary stack have one code path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import engine
from .bmps import check_rsvd


@dataclasses.dataclass
class SearchResult:
    """What a spectrum search returns (tnax's ``SearchResult``)."""
    energy: np.ndarray
    probability: np.ndarray
    degeneracy: int
    states: np.ndarray
    discarded_probability: float
    negative_probability: float
    merge_overflow: int = 0
    count_max: int = 0
    negative_probability_core: float = 0.0


def fleet_tables(solvers):
    """Check that ``solvers`` form a fleet and stack what the pipelines
    take into device tensors with a leading instance axis.

    The instances must share (Ny, Nx, Np, lh, lv), beta, device and dtype
    (ValueError otherwise). Returns a dict of the dims, the device and
    dtype, the host grids, the stacked shifted tables of the PEPS rows, the
    identity gauges X0, the valid vertical leg dims ndall (B, Ny-1, Nx),
    nvalid (B, Ny, Nx), beta and the host list cols (Ny, Nx) of
    snake-order columns.
    """
    if not solvers:
        raise ValueError("a fleet needs at least one solver")
    ins0 = solvers[0]
    grids = [engine.pad_grid(ins.problem) for ins in solvers]
    shape = lambda g: (g.Ny, g.Nx, g.Np, g.lh, g.lv)   # noqa: E731
    for ins, g in zip(solvers, grids):
        if shape(g) != shape(grids[0]):
            raise ValueError(f"fleet instances must share (Ny, Nx, Np, lh, "
                             f"lv): {shape(g)} != {shape(grids[0])}")
        if ins.beta != ins0.beta:
            raise ValueError(f"fleet instances share one beta: {ins.beta} "
                             f"!= {ins0.beta}")
        if (ins.device, ins.dtype) != (ins0.device, ins0.dtype):
            raise ValueError(f"fleet instances share one device and dtype: "
                             f"{ins.device} {ins.dtype} != {ins0.device} "
                             f"{ins0.dtype}")
    dtype, dev = ins0.dtype, ins0.device
    Ny, Nx, Np, lh, lv = shape(grids[0])
    B = len(solvers)

    def fleet(arrays, dt=dtype):
        """Stack one host array per instance into a device tensor."""
        return torch.as_tensor(np.stack(arrays), device=dev).to(dt)

    return dict(
        B=B, Ny=Ny, Nx=Nx, Np=Np, lh=lh, lv=lv, dtype=dtype, device=dev,
        grids=grids, problems=[ins.problem for ins in solvers],
        Es=fleet([g.Es for g in grids]), Esl=fleet([g.Esl for g in grids]),
        Esu=fleet([g.Esu for g in grids]),
        dmap=fleet([g.dmap for g in grids], torch.int32),
        rmap=fleet([g.rmap for g in grids], torch.int32),
        X0={k: fleet([v] * B)
            for k, v in engine.identity_gauges(grids[0]).items()},
        ndall=fleet([ins.problem.ld[: Ny - 1] for ins in solvers],
                    torch.int32),
        nvalid=fleet([g.nstates for g in grids], torch.int64),
        beta=float(ins0.beta),
        cols=(np.arange(Ny)[:, None] * Nx
              + np.arange(Nx)[None, :]).tolist())


class ContractionContext:
    """Padded device-side view of B same-shape problems at their beta and
    given gauges (tnax's ``ContractionContext`` with the instance axis).

    ``solvers`` is one Solver or a list of them (a fleet); ``gauges`` a
    dict of (B, Ny, Nx, l) tensors Xl, Xr, Xu, Xd (``interop.gauges``
    brings tnax's in), or None for the identity; ``tables`` the
    :func:`fleet_tables` of the solvers when the caller has them. Holds
    lB (B, Ny, Nx, Np, lh, lv), Wt (B, Ny, Nx, lh, lv, lh, lv) and
    drindex (B, Ny, Nx, Np) on the device; :meth:`build_boundary` adds
    the stack rhoT.
    """

    def __init__(self, solvers, gauges=None, *, tables=None):
        if not isinstance(solvers, (list, tuple)):
            solvers = [solvers]
        f = fleet_tables(solvers) if tables is None else tables
        self.tables = f
        self.problems = f["problems"]
        self.grids = f["grids"]
        self.B, self.Ny, self.Nx = f["B"], f["Ny"], f["Nx"]
        self.Np, self.lh, self.lv = f["Np"], f["lh"], f["lv"]
        self.beta, self.dtype, self.device = f["beta"], f["dtype"], f["device"]
        X = f["X0"] if gauges is None else gauges
        self.gauges = {k: torch.as_tensor(X[k], device=self.device)
                       .to(self.dtype) for k in ("Xl", "Xr", "Xu", "Xd")}
        self.nstates = np.stack([g.nstates for g in self.grids])
        self.dmap = np.stack([g.dmap for g in self.grids])
        self.rmap = np.stack([g.rmap for g in self.grids])
        G = self.gauges
        self.lB, self.Wt = engine.peps_rows(
            f["Es"], f["Esl"], f["Esu"], f["dmap"], f["rmap"], G["Xl"],
            G["Xr"], G["Xu"], G["Xd"], self.beta, lh=self.lh, lv=self.lv)
        self.drindex = f["dmap"].long() * self.lh + f["rmap"].long()
        self.rhoT = None
        self.Dmax = None
        self._boundary_key = None
        self._energy_rows = None

    def build_boundary(self, Dmax, tolS, tolV, max_sweeps, graduate=True,
                       rsvd=None, omega=None):
        """The boundary-MPS stacks rhoT (B, Ny+1, Nx, Dmax, lv, Dmax) of
        every instance (``engine.build_rhoT``). ``graduate`` is tnax's
        argument; it has no effect on the zip-up path. ``rsvd`` pins the
        zip-up's truncation (None or True: the randomized sketch, False:
        the exact SVD), ``omega`` is its sketch (``bmps.zipup_apply``).
        Also fills rhoT_overlap (B, Ny) and rhoT_discarded (B,), tensors
        on the device (no host read). A second call with the same
        arguments keeps the stack it built."""
        rsvd = check_rsvd(rsvd)
        key = (Dmax, tolS, tolV, max_sweeps, rsvd, id(omega))
        if key == self._boundary_key:
            return self.rhoT
        rhoT, _, overlaps, discarded = engine.build_rhoT(
            self.Wt, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
            rsvd=rsvd, omega=omega)
        self.rhoT, self.Dmax = rhoT, Dmax
        self.rhoT_overlap = overlaps
        self.rhoT_discarded = discarded.amax(dim=1)
        self._boundary_key = key
        return rhoT

    def energy_tables(self, ny, nx, b=0):
        """Host raw (unshifted) float64 energy tables (Es, Esl, Esu) of
        site (ny, nx) of instance b."""
        t = self.problems[b].site(ny, nx)
        return t.Es, t.Esl, t.Esu

    def energy_rows(self):
        """The raw float64 energy tables of every instance padded to grid
        shapes, (B, Ny, Nx, Np), (B, Ny, Nx, Np, lh), (B, Ny, Nx, Np, lv)
        on the device (made once per context)."""
        if self._energy_rows is None:
            rows = [padded_energy_rows(p) for p in self.problems]
            self._energy_rows = tuple(
                torch.as_tensor(np.stack([r[i] for r in rows]),
                                device=self.device) for i in range(3))
        return self._energy_rows


def padded_energy_rows(problem):
    """Raw (unshifted) energy tables padded to grid shapes (NumPy),
    cached on the problem."""
    cached = getattr(problem, "_energy_rows_np", None)
    if cached is not None:
        return cached
    g = engine.pad_grid(problem)
    Ny, Nx, Np, lh, lv = g.Ny, g.Nx, g.Np, g.lh, g.lv
    Es = np.zeros((Ny, Nx, Np))
    Esl = np.zeros((Ny, Nx, Np, lh))
    Esu = np.zeros((Ny, Nx, Np, lv))
    for ny in range(Ny):
        for nx in range(Nx):
            t = problem.site(ny, nx)
            n = len(t.Es)
            Es[ny, nx, :n] = t.Es
            Esl[ny, nx, :n, :t.Esl.shape[1]] = t.Esl
            Esu[ny, nx, :n, :t.Esu.shape[1]] = t.Esu
    problem._energy_rows_np = (Es, Esl, Esu)
    return problem._energy_rows_np
