"""The contraction context, and the host-exact ground-state search.

Counterpart of ``tnax/search.py``. :class:`ContractionContext` holds B
same-shape problems as device tensors at one beta and one set of gauges,
and their boundary-MPS stack, with the instance axis B that every core
function of the port carries: one Solver's context is the case B = 1, a
fleet's is B instances that share (Ny, Nx, Np, lh, lv), beta, device and
dtype. The flagship pipelines (``parallel``) build their stacks through
this class too, so the tables, the PEPS rows and the boundary stack have
one code path.

:func:`search_ground_state` is tnax's exact beam bookkeeping (the
``path="host"`` default of ``Solver.search_ground_state``): per site the
device computes every branch's marginals and log2-probabilities (kernel
K3 in the epilogue), and the host reads them once, then applies the
relative cutoff, merges branches by boundary-index vector with float64
energies and int64 degeneracies, keeps the top M, and sends the parents'
indices back for the left-environment update. The low-energy spectrum's
host path (``spectrum.search_spectrum``) runs the same site helpers.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from . import engine
from .bmps import check_rsvd
from .config import StageClock, recording
from .kernels.marginal import NEG, boltzmann_columns

logger = logging.getLogger("tnax_torch")


@dataclasses.dataclass
class SearchResult:
    """What a search returns (tnax's ``SearchResult``). ``merge_overflow``
    and ``count_max`` are the capped device paths' exactness diagnostics:
    the sites whose candidates exceeded the cap and the largest count
    (the host path merges every survivor; its count_max is diagnostic)."""
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
    (ValueError otherwise). Returns :func:`problem_tables` of their
    problems at their beta, device and dtype.
    """
    if not solvers:
        raise ValueError("a fleet needs at least one solver")
    ins0 = solvers[0]
    for ins in solvers:
        if ins.beta != ins0.beta:
            raise ValueError(f"fleet instances share one beta: {ins.beta} "
                             f"!= {ins0.beta}")
        if (ins.device, ins.dtype) != (ins0.device, ins0.dtype):
            raise ValueError(f"fleet instances share one device and dtype: "
                             f"{ins.device} {ins.dtype} != {ins0.device} "
                             f"{ins0.dtype}")
    return problem_tables([ins.problem for ins in solvers], ins0.beta,
                          ins0.device, ins0.dtype)


def problem_tables(problems, beta, device, dtype):
    """The tables of same-shape problems (ValueError unless they share
    (Ny, Nx, Np, lh, lv)) as device tensors with a leading instance axis:
    a dict of the dims, the device and dtype, the host grids and
    problems, the stacked shifted tables of the PEPS rows, the identity
    gauges X0, the valid vertical leg dims ndall (B, Ny-1, Nx), nvalid
    (B, Ny, Nx), beta and the host list cols (Ny, Nx) of snake-order
    columns."""
    if not problems:
        raise ValueError("need at least one problem")
    grids = [engine.pad_grid(p) for p in problems]
    shape = lambda g: (g.Ny, g.Nx, g.Np, g.lh, g.lv)   # noqa: E731
    for g in grids:
        if shape(g) != shape(grids[0]):
            raise ValueError(f"fleet instances must share (Ny, Nx, Np, lh, "
                             f"lv): {shape(g)} != {shape(grids[0])}")
    Ny, Nx, Np, lh, lv = shape(grids[0])
    B = len(problems)

    def fleet(arrays, dt=dtype):
        """Stack one host array per instance into a device tensor."""
        return torch.as_tensor(np.stack(arrays), device=device).to(dt)

    return dict(
        B=B, Ny=Ny, Nx=Nx, Np=Np, lh=lh, lv=lv, dtype=dtype, device=device,
        grids=grids, problems=list(problems),
        Es=fleet([g.Es for g in grids]), Esl=fleet([g.Esl for g in grids]),
        Esu=fleet([g.Esu for g in grids]),
        dmap=fleet([g.dmap for g in grids], torch.int32),
        rmap=fleet([g.rmap for g in grids], torch.int32),
        X0={k: fleet([v] * B)
            for k, v in engine.identity_gauges(grids[0]).items()},
        ndall=fleet([p.ld[: Ny - 1] for p in problems], torch.int32),
        nvalid=fleet([g.nstates for g in grids], torch.int64),
        beta=float(beta),
        cols=(np.arange(Ny)[:, None] * Nx
              + np.arange(Nx)[None, :]).tolist())


class ContractionContext:
    """Padded device-side view of B same-shape problems at their beta and
    given gauges (tnax's ``ContractionContext`` with the instance axis).

    ``solvers`` is one Solver or a list of them (a fleet); ``gauges`` a
    dict of (B, Ny, Nx, l) tensors Xl, Xr, Xu, Xd (``interop.gauges``
    brings tnax's in), or None for the identity; ``tables`` the
    :func:`fleet_tables` of the solvers when the caller has them, ``rows``
    their PEPS rows (lB, Wt) at these gauges. Holds lB (B, Ny, Nx, Np, lh,
    lv), Wt (B, Ny, Nx, lh, lv, lh, lv) and drindex (B, Ny, Nx, Np) on the
    device; :meth:`build_boundary` adds the stack rhoT.
    """

    def __init__(self, solvers, gauges=None, *, tables=None, rows=None):
        if not isinstance(solvers, (list, tuple)):
            solvers = [solvers]
        f = fleet_tables(solvers) if tables is None else tables
        self.solvers = list(solvers)
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
            G["Xr"], G["Xu"], G["Xd"], self.beta, lh=self.lh, lv=self.lv) \
            if rows is None else rows
        self.drindex = f["dmap"].long() * self.lh + f["rmap"].long()
        self.rhoT = None
        self.Dmax = None
        self._boundary_key = None
        self._energy_rows = None

    @classmethod
    def stack(cls, ctxs):
        """One context of the instances of the contexts ``ctxs`` (which
        must form a fleet, as :func:`fleet_tables` checks), their gauges
        and PEPS rows concatenated along B, and their boundary stacks too
        where every context holds one built with the same arguments. A
        list of one context is that context."""
        if not ctxs:
            raise ValueError("need at least one context")
        if len(ctxs) == 1:
            return ctxs[0]
        cat = torch.cat
        out = cls([s for c in ctxs for s in c.solvers],
                  {k: cat([c.gauges[k] for c in ctxs])
                   for k in ctxs[0].gauges},
                  rows=(cat([c.lB for c in ctxs]), cat([c.Wt for c in ctxs])))
        keys = {c._boundary_key for c in ctxs}
        if len(keys) == 1 and None not in keys:
            out.rhoT = cat([c.rhoT for c in ctxs])
            out.rhoT_overlap = cat([c.rhoT_overlap for c in ctxs])
            out.rhoT_discarded = cat([c.rhoT_discarded for c in ctxs])
            out.Dmax, out._boundary_key = ctxs[0].Dmax, keys.pop()
        return out

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


# ---------------------------------------------------------------------------
# the host paths' site loop: device side
# ---------------------------------------------------------------------------

def _pad1(x, M, fill=0):
    out = np.full((M,) + x.shape[1:], fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def upload(a, device):
    """The host array ``a`` as a tensor on ``device``, without waiting for
    the device: on CUDA through pinned memory, copied asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def host_read(*tensors):
    """Device tensors as NumPy arrays with one wait for the device: on
    CUDA each is copied into pinned memory without blocking, and a single
    stream synchronize ends the read (timed by a recording stage
    clock)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    stream, rec = torch.cuda.current_stream(dev), recording()
    if rec is None:
        stream.synchronize()
    else:
        rec.read(stream.synchronize)
    return [h.numpy() for h in host]


class HostSites:
    """The device side of the host paths' site loop, on a context of one
    instance whose boundary stack is built: the right environments of a
    row's branches, the marginal epilogue of a site's branches (kernel K3
    on CUDA) and the left-environment update. The host's beam state goes
    up once per row and twice per site (the branches' indices, the
    parents' picks), always without waiting; the site's outputs come back
    in :func:`expand_candidates`."""

    def __init__(self, ctx, M, relative_P_cutoff):
        if ctx.B != 1:
            raise ValueError(f"the host paths take a context of one "
                             f"instance, got {ctx.B}")
        self.ctx, self.M = ctx, M
        self.log2_cutoff = float(np.log2(relative_P_cutoff)) \
            if relative_P_cutoff > 0 else NEG
        # the Boltzmann tables with the states last, made once per search
        self.lBT = boltzmann_columns(ctx.lB)
        self.nvalid = ctx.tables["nvalid"]
        self.ar = torch.arange(M, device=ctx.device)

    def start_row(self, ny, vind):
        """Row ny's right environments of the branches ``vind`` (K, Nx+1);
        returns the unit left environments (1, M, D)."""
        ctx, M = self.ctx, self.M
        self.ny = ny
        self.AT_row = ctx.rhoT[:, ny + 1]
        uidx = upload(_pad1(vind[:, 1:], M).astype(np.int64), ctx.device)
        self.RRs = engine.row_right_envs(self.AT_row, ctx.Wt[:, ny],
                                         uidx[None])
        RL = torch.zeros((1, M, ctx.Dmax), dtype=ctx.dtype,
                         device=ctx.device)
        RL[:, :, 0] = 1.0
        return RL

    def marginals(self, nx, RL, aidx, vind, prob):
        """K3 on site nx of the row for the K branches: their parents'
        right environments ``aidx``, leg values from ``vind`` and
        log2-probabilities ``prob`` (float64, -inf allowed). Returns
        (probf (1, M, Np), pmax, mq, mqc) on the device, NEG for invalid
        branches and zero marginals."""
        ctx, M, ny = self.ctx, self.M, self.ny
        K = len(prob)
        idx = upload(np.stack([_pad1(aidx, M), _pad1(vind[:, nx], M),
                               _pad1(vind[:, nx + 1], M)]).astype(np.int64),
                     ctx.device)
        p = upload(_pad1(np.maximum(prob, NEG), M, fill=NEG), ctx.device)
        RRsel = engine._take(self.RRs[:, nx], idx[0][None])
        probf, _, pmax, mq, mqc = engine.marginal_probf(
            self.lBT[:, ny, nx], ctx.drindex[:, ny, nx], self.AT_row[:, nx],
            RL, RRsel, idx[1][None], idx[2][None], self.nvalid[:, ny, nx],
            p.to(ctx.dtype)[None], (self.ar < K)[None], self.log2_cutoff)
        return probf, pmax, mq, mqc

    def rl_update(self, nx, RL, parent, dvind):
        """The kept branches' left environments: their parents', with the
        site nx absorbed at their down-leg values ``dvind``."""
        M = self.M
        idx = upload(np.stack([_pad1(parent, M), _pad1(dvind, M)])
                     .astype(np.int64), self.ctx.device)
        return engine.rl_update(engine._take(RL, idx[0][None]),
                                self.AT_row[:, nx], idx[1][None])


# ---------------------------------------------------------------------------
# vectorized beam bookkeeping (host), tnax's
# ---------------------------------------------------------------------------

CAND_CAP = 32768   # the fast path's top candidates read per site


def expand_candidates(probf_d, pmax_d, mq_d, mqc_d, prob, K, n, Np, M,
                      relative_P_cutoff, pd_max):
    """Expand branch x block-state candidates and apply the relative
    cutoff (tnax's ``expand_candidates``, reference
    `tnac4o/tnac4o.py:456-465`), from :meth:`HostSites.marginals`'s
    outputs, with one read of the device.

    Fast path (cutoff > 0, more than one candidate, float32): the device
    sorts the expansion and the host reads the top ``CAND_CAP`` values and
    indices with the count above the cutoff; if fewer survive than were
    read, they are the survivors. Otherwise (float64, no cutoff, or too
    many survivors) the host reads the whole (K, n) table of
    log2-probabilities, zero marginals as -inf as tnax's log2 of them,
    and cuts it in float64.

    Returns (inds, indc, probf, pd_max, minP, minP_core): each survivor's
    branch and state, its log2-probability, and the negativeness over
    the valid branches and over those within the cutoff window of the
    best.
    """
    kk = min(CAND_CAP, M * Np)
    if relative_P_cutoff > 0 and kk > 1 and probf_d.dtype == torch.float32:
        flat = probf_d.reshape(-1)
        vals, idx = torch.sort(flat, descending=True, stable=True)
        count = (flat > pmax_d + float(np.log2(relative_P_cutoff))).sum()
        vals, idx, count, minP, minP_core = host_read(
            vals[:kk], idx[:kk], count, mq_d[0], mqc_d[0])
        count = int(count)
        if count < kk:
            vals = vals.astype(np.float64)
            keep = max(count, 1)
            if keep < K * n:
                pd_max = max(pd_max, vals[keep])
            inds = idx[:keep] // Np
            indc = (idx[:keep] % Np).astype(np.int32)
            return (inds, indc, vals[:keep], pd_max, float(minP),
                    float(minP_core))
    probf, minP, minP_core = host_read(probf_d[0, :K, :n], mq_d[0],
                                       mqc_d[0])
    probf = np.where(probf <= NEG / 2, -np.inf,
                     probf.astype(np.float64)).ravel()
    minP = float(minP)
    minP_core = float(minP_core) if relative_P_cutoff > 0 else minP
    order, probf, pd_max = cutoff_select(probf, relative_P_cutoff, pd_max)
    return (order // n, (order % n).astype(np.int32), probf, pd_max, minP,
            minP_core)


def cutoff_select(probf, relative_P_cutoff, pd_max):
    """Relative-probability cutoff (reference `tnac4o/tnac4o.py:456-465`).

    Returns (order, probf, pd_max)."""
    order = np.arange(probf.size)
    if relative_P_cutoff > 0:
        cutoff = np.max(probf) + np.log2(relative_P_cutoff)
        keep = max(int((probf > cutoff).sum()), 1)
        if keep < probf.size:
            order = probf.argpartition(-keep - 1)
            pd_max = max(pd_max, probf[order[-keep - 1]])
            order = order[-keep:]
            probf = probf[order]
    return order, probf, pd_max


def top_m(prob, M, pd_max):
    """Keep the M most probable entries (reference
    `tnac4o/tnac4o.py:518-526`). Returns (indices, pd_max)."""
    if prob.size > M:
        order = prob.argpartition(-M - 1)
        pd_max = max(pd_max, prob[order[-M - 1]])
        return order[-M:], pd_max
    return np.arange(prob.size), pd_max


def merge_by_vind(vind, Eng, prob, deg, min_dEng):
    """Merge branches with identical boundary-index vectors (reference
    `tnac4o/tnac4o.py:481-515`, vectorized as tnax does): the
    minimum-energy member represents each group, degeneracies of members
    within ``min_dEng`` of the minimum are summed, and their
    log2-probabilities averaged.

    Returns (vindn, rep, degn, probn, order, starts, g) where ``rep``
    indexes the input arrays and the last three expose the grouping for
    the spectrum search's droplet recording.
    """
    vindn, inv = np.unique(vind, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    g = inv[order]
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    Eo = Eng[order]
    Emin = np.minimum.reduceat(Eo, starts)
    Eming = Emin[g]
    pos = np.arange(len(g))
    cand = np.where(Eo == Eming, pos, len(g))
    rep = order[np.minimum.reduceat(cand, starts)]
    sel = (Eo - Eming) <= min_dEng
    dego = np.where(sel, deg[order], 0)
    degn = np.add.reduceat(dego, starts)
    nsel = np.add.reduceat(sel.astype(np.int64), starts)
    probn = np.add.reduceat(np.where(sel, prob[order], 0.0), starts) / nsel
    return vindn, rep, degn, probn, order, starts, g


# ---------------------------------------------------------------------------
# the host-exact ground-state search
# ---------------------------------------------------------------------------

def search_ground_state(ctx, M=2 ** 10, relative_P_cutoff=1e-6,
                        min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                        max_sweeps=20, graduate_truncation=True,
                        checkpoint_path=None, resume=False,
                        _stop_after_rows=None, omega=None,
                        stage_times=None) -> SearchResult:
    """Most-probable-state search with exact host beam bookkeeping
    (tnax's ``search_ground_state``, reference `tnac4o/tnac4o.py:381-551`)
    on a context of one instance.

    ``checkpoint_path`` snapshots the beam after every lattice row (an
    ``.npz`` in tnax's format, so either package resumes the other's);
    ``resume=True`` continues from such a snapshot (the caller rebuilds
    the same problem, beta and gauges; the boundary is rebuilt).
    ``omega`` is the zip-up's sketch (``bmps.zipup_apply``);
    ``stage_times``, if a dict, receives the seconds of the boundary and
    of the search.
    """
    with StageClock(stage_times, ctx.device) as clock:
        t_total = time.time()
        if checkpoint_path and not str(checkpoint_path).endswith(".npz"):
            # np.savez appends '.npz': resume loads the file it wrote
            checkpoint_path = str(checkpoint_path) + ".npz"
        logger.info("Preprocessing boundary MPS (D=%d) ...", Dmax)
        ctx.build_boundary(Dmax, tolS, tolV, max_sweeps, graduate_truncation,
                           omega=omega)
        clock.lap("boundary")
        logger.info("Elapsed: %.2f s", time.time() - t_total)

        Ny, Nx = ctx.Ny, ctx.Nx
        vind = np.zeros((1, Nx + 1), dtype=np.int32)
        states = np.zeros((1, Nx * Ny), dtype=np.int32)
        Eng = np.zeros(1)
        prob = np.zeros(1)
        deg = np.ones(1, dtype=np.int64)
        pd_max, globalmin, globalmin_core = -np.inf, 0.0, 0.0
        count_max = 0
        ny_start = 0
        if resume and checkpoint_path:
            ck = np.load(checkpoint_path)
            ny_start = int(ck["ny"])
            vind, states = ck["vind"], ck["states"]
            Eng, prob, deg = ck["Eng"], ck["prob"], ck["deg"]
            pd_max, globalmin = float(ck["pd_max"]), float(ck["globalmin"])
            if "globalmin_core" in ck:
                globalmin_core = float(ck["globalmin_core"])
            logger.info("Resuming from row %d (%s)", ny_start, checkpoint_path)

        sites = HostSites(ctx, M, relative_P_cutoff)
        for ny in range(ny_start, Ny):
            t_row = time.time()
            K = len(prob)
            RL = sites.start_row(ny, vind)
            aidx = np.arange(K, dtype=np.int32)

            for nx in range(Nx):
                n = int(ctx.nstates[0, ny, nx])
                inds, indc, probf, pd_max, minP, minP_core = expand_candidates(
                    *sites.marginals(nx, RL, aidx, vind, prob), prob, K, n,
                    ctx.Np, M, relative_P_cutoff, pd_max)
                globalmin = min(globalmin, minP)
                globalmin_core = min(globalmin_core, minP_core)
                count_max = max(count_max, len(probf))
                states = states[inds]
                states[:, ny * Nx + nx] = indc
                vind = vind[inds]
                deg = deg[inds]
                aidx = aidx[inds]
                Eng = Eng[inds]
                # exact f64 energy of the newly fixed block
                Es, Esl, Esu = ctx.energy_tables(ny, nx)
                Eng = Eng + Es[indc] + Esl[indc, vind[:, nx]] \
                    + Esu[indc, vind[:, nx + 1]]
                vind[:, nx] = ctx.dmap[0, ny, nx][indc]
                vind[:, nx + 1] = ctx.rmap[0, ny, nx][indc]

                vindn, rep, degn, probn, _, _, _ = merge_by_vind(
                    vind, Eng, probf, deg, min_dEng)

                keep, pd_max = top_m(probn, M, pd_max)
                vind = vindn[keep]
                prob = probn[keep]
                deg = degn[keep]
                rk = rep[keep]
                states = states[rk]
                Eng = Eng[rk]
                parent = inds[rk].astype(np.int32)
                aidx = aidx[rk]
                K = len(prob)
                RL = sites.rl_update(nx, RL, parent, vind[:, nx])

            logger.info("Row %d/%d: %d branches, %.2f s", ny + 1, Ny, K,
                        time.time() - t_row)
            vind[:, 1:] = vind[:, :-1]
            vind[:, 0] = 0
            if checkpoint_path:
                np.savez(checkpoint_path, ny=ny + 1, vind=vind, states=states,
                         Eng=Eng, prob=prob, deg=deg, pd_max=pd_max,
                         globalmin=globalmin, globalmin_core=globalmin_core)
            if _stop_after_rows is not None and ny + 1 >= _stop_after_rows:
                break
        clock.lap("search")
    logger.info("Search total: %.2f s", time.time() - t_total)

    return SearchResult(
        energy=Eng, probability=prob, degeneracy=int(deg[0]),
        states=states, discarded_probability=float(pd_max),
        negative_probability=min(globalmin, 0.0),
        negative_probability_core=min(globalmin_core, 0.0),
        count_max=int(count_max))
