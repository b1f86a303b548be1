"""Contraction engine: padded grid, PEPS row factory, boundary-MPS stack,
row environments and batched conditional marginals (torch).

Counterpart of ``tnax/engine.py``. Every device function takes a leading
instance axis B (tnax vmaps over fleet instances); a single search is the
case B = 1. A site's 5-leg PEPS tensor
W[s, l, d, r, u] is never materialized; it factorizes exactly as

    W[s, l, d, r, u] = B[s, l, u] * delta(d == dmap[s]) * delta(r == rmap[s])

with ``B`` the gauged Boltzmann factor of the block and its left/up
couplings. The search needs only ``log B`` (marginals) and the physically
traced MPO tensor ``Wt[l, d, r, u] = sum_s W[s, l, d, r, u]`` (boundary
MPS).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bmps, config
from .kernels import marginal as _marginal
from .problems import Problem


# ---------------------------------------------------------------------------
# padded grid of energy tables (host, NumPy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PaddedGrid:
    """Statically padded per-site tables for the whole lattice.

    Shifted energies are ``E - min(E)`` per table; padded entries hold
    ``+inf`` so that ``exp(-beta * E)`` vanishes there.
    """
    Ny: int
    Nx: int
    Np: int   # padded number of block states
    lh: int   # padded horizontal leg dim
    lv: int   # padded vertical leg dim
    Es: np.ndarray       # (Ny, Nx, Np)        shifted, +inf padded
    Esl: np.ndarray      # (Ny, Nx, Np, lh)    shifted, +inf padded
    Esu: np.ndarray      # (Ny, Nx, Np, lv)    shifted, +inf padded
    dmap: np.ndarray     # (Ny, Nx, Np) int32
    rmap: np.ndarray     # (Ny, Nx, Np) int32
    nstates: np.ndarray  # (Ny, Nx) int


def pad_grid(problem: Problem) -> PaddedGrid:
    cached = getattr(problem, "_grid_cache", None)
    if cached is not None:
        return cached
    Ny, Nx = problem.Ny, problem.Nx
    sites = [[problem.site(ny, nx) for nx in range(Nx)] for ny in range(Ny)]
    Np = max(t.n for row in sites for t in row)
    lh = max(max(t.nl, t.nr) for row in sites for t in row)
    lv = max(max(t.nu, t.nd) for row in sites for t in row)
    Es = np.full((Ny, Nx, Np), np.inf)
    Esl = np.full((Ny, Nx, Np, lh), np.inf)
    Esu = np.full((Ny, Nx, Np, lv), np.inf)
    dmap = np.zeros((Ny, Nx, Np), dtype=np.int32)
    rmap = np.zeros((Ny, Nx, Np), dtype=np.int32)
    nstates = np.zeros((Ny, Nx), dtype=int)
    for ny in range(Ny):
        for nx in range(Nx):
            t = sites[ny][nx]
            Es[ny, nx, :t.n] = t.Es - t.Es.min()
            Esl[ny, nx, :t.n, :t.nl] = t.Esl - t.Esl.min()
            Esu[ny, nx, :t.n, :t.nu] = t.Esu - t.Esu.min()
            dmap[ny, nx, :t.n] = t.dmap
            rmap[ny, nx, :t.n] = t.rmap
            nstates[ny, nx] = t.n
    out = PaddedGrid(Ny=Ny, Nx=Nx, Np=Np, lh=lh, lv=lv, Es=Es, Esl=Esl,
                     Esu=Esu, dmap=dmap, rmap=rmap, nstates=nstates)
    problem._grid_cache = out
    return out


def identity_gauges(grid: PaddedGrid, dtype=np.float64):
    """Balancing gauges, all ones. Xd[ny]*Xu[ny+1] == 1 is the invariant."""
    Ny, Nx = grid.Ny, grid.Nx
    return dict(
        Xl=np.ones((Ny, Nx, grid.lh), dtype=dtype),
        Xr=np.ones((Ny, Nx, grid.lh), dtype=dtype),
        Xu=np.ones((Ny, Nx, grid.lv), dtype=dtype),
        Xd=np.ones((Ny, Nx, grid.lv), dtype=dtype),
    )


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def peps_rows(Es, Esl, Esu, dmap, rmap, Xl, Xr, Xu, Xd, beta, *, lh, lv):
    """Gauged log-Boltzmann factors lB and traced MPO tensors Wt.

    Any batch prefix works (``(Ny, Nx)`` or ``(Nx,)``):
      Es (..., Np), Esl (..., Np, lh), Esu (..., Np, lv): shifted energies;
      dmap/rmap (..., Np) copy-leg index maps; Xl/Xr (..., lh),
      Xu/Xd (..., lv) balancing gauges.

    Returns lB (..., Np, lh, lv), -inf on padding (the log domain keeps
    exact relative weights where exp(-beta*E) underflows), and
    Wt (..., lh, lv, lh, lv) with legs (l, d, r, u).
    """
    dmap, rmap = dmap.long(), rmap.long()
    expo = Es[..., None, None] + Esl[..., :, None] + Esu[..., None, :]
    Xd_s = torch.gather(Xd, -1, dmap)                 # (..., Np)
    Xr_s = torch.gather(Xr, -1, rmap)
    lB = -beta * expo + torch.log(Xl)[..., None, :, None] \
        + torch.log(Xu)[..., None, None, :] \
        + torch.log(Xd_s * Xr_s)[..., :, None, None]
    B = torch.exp(lB)
    dr = dmap * lh + rmap                             # (..., Np), d-major
    P = torch.nn.functional.one_hot(dr, lv * lh).to(B.dtype)
    Wt = torch.einsum("...slu,...sk->...lku", B, P)
    Wt = Wt.reshape(Wt.shape[:-3] + (lh, lv, lh, lv))
    return lB, Wt


def _absorb_row(mps, Wrow, conj, Dmax, tolS, tolV, max_sweeps, graduate,
                method, rsvd, omega):
    """One row (or column) absorbed into the boundary: the zip-up
    (``bmps.compress_apply``) or the fat path (``bmps.apply_mpo`` then
    ``bmps.compress`` with graduate truncation). Returns (MPS, overlap,
    discarded, sweeps), each (B,)."""
    if method == "zipup":
        return bmps.compress_apply(mps, Wrow, Dmax, conj=conj, tolS=tolS,
                                   tolV=tolV, max_sweeps=max_sweeps,
                                   rsvd=rsvd, omega=omega)
    if method != "fat":
        raise ValueError(f"method must be 'zipup' or 'fat', got {method!r}")
    fat = bmps.apply_mpo(mps, Wrow, conj=conj)
    return bmps.compress(fat, Dmax, tolS=tolS, tolV=tolV,
                         max_sweeps=max_sweeps, graduate=graduate)


def _build_stack(rows, *, conj, forward, Dmax, tolS, tolV, max_sweeps,
                 graduate, method, rsvd, omega):
    """A boundary-MPS stack over the rows (B, N, L, l, d, r, u), absorbed
    in order (``forward``) or in reverse, each with ``conj``. Returns
    (rho (B, N+1, L, Dmax, d, Dmax), lognorms (B, N+1), overlaps (B, N),
    discarded (B, N)) in row order: the trivial boundary first (forward)
    or last (reverse); overlaps[:, k] and discarded[:, k] are those of
    absorbing row k. A recording stage clock counts the N ``rows``."""
    B, N, L = rows.shape[:3]
    mps = mps0 = bmps.trivial_mps(B, L, Dmax, rows.shape[4], rows.dtype,
                                  rows.device)
    As, lns, ovs, dss = [], [], [], []
    for k in (range(N) if forward else range(N - 1, -1, -1)):
        mps, overlap, disc, _ = _absorb_row(
            mps, rows[:, k], conj, Dmax, tolS, tolV, max_sweeps, graduate,
            method, rsvd, omega)
        As.append(mps.A)
        lns.append(mps.lognorm)
        ovs.append(overlap)
        dss.append(disc)
    rec = config.recording()
    if rec is not None:
        rec.count("rows", N)
    zero = torch.zeros_like(mps0.lognorm)
    if forward:
        As, lns = [mps0.A] + As, [zero] + lns
    else:
        As, lns, ovs, dss = (As[::-1] + [mps0.A], lns[::-1] + [zero],
                             ovs[::-1], dss[::-1])
    return (torch.stack(As, dim=1), torch.stack(lns, dim=1),
            torch.stack(ovs, dim=1), torch.stack(dss, dim=1))


def build_rhoT(Wt, *, Dmax, tolS, tolV, max_sweeps, graduate=True,
               method="zipup", rsvd=True, omega=None):
    """Boundary-MPS stacks from the bottom edge upward.

    Wt: (B, Ny, Nx, lh, lv, lh, lv) traced row tensors of B instances.
    Returns (rhoT, lognorms, overlaps, discarded) with leading axis B;
    rhoT[b, ny] (ny=0..Ny) contracts rows ny..Ny-1 as an MPS over columns
    whose physical legs are the up-legs of row ny; rhoT[b, Ny] is the
    trivial boundary. ``method`` "zipup" absorbs each row fat-MPS-free
    (``rsvd`` and ``omega`` set its truncation, see
    ``bmps.zipup_apply``); "fat" materializes the D*l-bond MPS and
    compresses it with the reference's schedule (``graduate`` truncation;
    ``graduate`` has no effect on the zip-up).
    """
    return _build_stack(Wt, conj=True, forward=False, Dmax=Dmax, tolS=tolS,
                        tolV=tolV, max_sweeps=max_sweeps, graduate=graduate,
                        method=method, rsvd=rsvd, omega=omega)


def build_rhoB(Wt, *, Dmax, tolS, tolV, max_sweeps, graduate=True,
               method="zipup", rsvd=True, omega=None):
    """Boundary-MPS stacks from the top edge downward (the mirror of
    :func:`build_rhoT`): rhoB[b, ny] contracts rows 0..ny-1, its physical
    legs on the up-legs of row ny; rhoB[b, 0] is trivial. Returns (rhoB,
    lognorms, overlaps, discarded) as :func:`build_rhoT` does (tnax's
    returns no lognorms)."""
    return _build_stack(Wt, conj=False, forward=True, Dmax=Dmax, tolS=tolS,
                        tolV=tolV, max_sweeps=max_sweeps, graduate=graduate,
                        method=method, rsvd=rsvd, omega=omega)


def columns_view(Wt):
    """The traced tensors (B, Ny, Nx, l, d, r, u) reoriented for the
    column-wise (left/right) boundary MPS, (B, Nx, Ny, u, l, d, r): the
    chain legs become the vertical (u, d) legs and the contracted and
    output physical legs the horizontal (l, r) ones."""
    return Wt.permute(0, 2, 1, 6, 3, 4, 5)


def build_rhoL(Wt, *, Dmax, tolS, tolV, max_sweeps, graduate=True,
               method="zipup", rsvd=True, omega=None):
    """Boundary-MPS stacks from the left edge rightward: rhoL[b, nx]
    (nx=0..Nx) contracts columns 0..nx-1 as an MPS over the rows whose
    physical legs are the left-legs of column nx; rhoL[b, 0] is trivial.
    The zip-up's sketch ``omega`` has the chain length Ny. Returns
    (rhoL, lognorms, overlaps, discarded)."""
    return _build_stack(columns_view(Wt), conj=True, forward=True,
                        Dmax=Dmax, tolS=tolS, tolV=tolV,
                        max_sweeps=max_sweeps, graduate=graduate,
                        method=method, rsvd=rsvd, omega=omega)


def build_rhoR(Wt, *, Dmax, tolS, tolV, max_sweeps, graduate=True,
               method="zipup", rsvd=True, omega=None):
    """Boundary-MPS stacks from the right edge leftward: rhoR[b, nx]
    contracts columns nx..Nx-1, its physical legs on the left-legs of
    column nx; rhoR[b, Nx] is trivial. Returns (rhoR, lognorms,
    overlaps, discarded)."""
    return _build_stack(columns_view(Wt), conj=False, forward=False,
                        Dmax=Dmax, tolS=tolS, tolV=tolV,
                        max_sweeps=max_sweeps, graduate=graduate,
                        method=method, rsvd=rsvd, omega=omega)


def _swap_du(Wt):
    """The traced tensors with their down and up legs swapped: a
    conj=False absorption of Wt is a conj=True absorption of this."""
    return Wt.permute(0, 1, 2, 3, 6, 5, 4)


def build_rho_both(Wt, *, Dmax, tolS, tolV, max_sweeps, rsvd=True,
                   omega=None):
    """Both zip-up boundary stacks (rhoT, rhoB) of B instances in one
    batched build of 2B lanes.

    A bottom-boundary row absorption is a top-boundary absorption of the
    up/down-swapped tensor, and the forward build is the reverse build
    over the row-flipped stack, so rhoB is :func:`build_rhoT` of the
    mirrored rows; tnax batches the two lanes the same way
    (tnax/engine.py:243-259). Each lane stops its own sweeps, so each is
    the unbatched build.
    """
    B = Wt.shape[0]
    WtB = torch.flip(_swap_du(Wt), dims=(1,))
    rho = build_rhoT(torch.cat([Wt, WtB]), Dmax=Dmax, tolS=tolS, tolV=tolV,
                     max_sweeps=max_sweeps, rsvd=rsvd, omega=omega)[0]
    rhoT, rhoBm = rho[:B], rho[B:]
    rhoB = torch.cat([rhoBm[:, -1:], torch.flip(rhoBm[:, :-1], dims=(1,))],
                     dim=1)
    return rhoT, rhoB


def build_rho_lr(Wt, *, Dmax, tolS, tolV, max_sweeps, rsvd=True,
                 omega=None):
    """Both zip-up column stacks (rhoL, rhoR) of B instances in one build
    of 2B lanes: rhoR is the top-boundary build of the up/down-swapped
    column view and rhoL the mirrored lane (see :func:`build_rho_both`)."""
    rhoR, rhoL = build_rho_both(
        _swap_du(columns_view(Wt)), Dmax=Dmax, tolS=tolS, tolV=tolV,
        max_sweeps=max_sweeps, rsvd=rsvd, omega=omega)
    return rhoL, rhoR


def _take(x, idx):
    """Per-instance gather of rows: x (B, N, ...), idx (B, K) -> (B, K, ...)
    with out[b, k] = x[b, idx[b, k]]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _rr_absorb_twogemm(AT, Wt, u, rr):
    """One right-env absorption: contract rr with AT over the bond as one
    GEMM, contract that with the full traced tensor for every up-leg
    value q as a second GEMM, then select q = u_m per branch. AT
    (B, D, lv, D), Wt (B, lh, lv, lh, lv), u (B, M), rr (B, M, D, lh)."""
    T = torch.einsum("zmbr,zadb->zmrad", rr, AT)          # (B, M, lh, D, lv)
    new_all = torch.einsum("zmrad,zldrq->zmalq", T, Wt)   # (B, M, D, lh, q)
    idx = u.long()[:, :, None, None, None].expand(new_all.shape[:4] + (1,))
    return torch.gather(new_all, 4, idx)[..., 0]


def row_right_envs(AT_row, Wt_row, uidx):
    """Right environments of the active row for every branch.

    AT_row (B, Nx, D, lv, D) boundary MPS below the row; Wt_row
    (B, Nx, lh, lv, lh, lv) traced tensors of the row; uidx (B, M, Nx)
    up-leg indices per branch per site. Returns RRs (B, Nx, M, D, lh):
    RRs[b, nx, m] is the environment of sites nx+1..Nx-1 (trivial at
    nx = Nx-1), each rescaled to max |entry| 1. The stack is site-major
    in memory, so one site's (B, M, D, lh) slice is contiguous and the
    sampler's second GEMM reads it without a copy.
    """
    B, Nx, D, lv, _ = AT_row.shape
    lh = Wt_row.shape[2]
    M = uidx.shape[1]
    rr = torch.zeros((B, M, D, lh), dtype=AT_row.dtype, device=AT_row.device)
    rr[:, :, 0, 0] = 1.0
    RRs = [rr] * Nx
    for s in range(Nx - 1, 0, -1):
        new = _rr_absorb_twogemm(AT_row[:, s], Wt_row[:, s], uidx[:, :, s],
                                 rr)
        scale = new.abs().amax(dim=(2, 3), keepdim=True)
        rr = new / torch.where(scale > 0, scale, 1.0)
        RRs[s - 1] = rr
    return torch.stack(RRs).transpose(0, 1)


def _marginal_T2(AT, RL, RRsel):
    """The two GEMMs of a marginal: (B, M, lv*lh) per-branch products.
    AT (B, D, lv, D), RL (B, M, D), RRsel (B, M, D, lh)."""
    B, M, D = RL.shape
    lv, lh = AT.shape[2], RRsel.shape[3]
    T1 = torch.bmm(RL, AT.reshape(B, D, lv * D)).reshape(B * M, lv, D)
    return torch.bmm(T1, RRsel.reshape(B * M, D, lh)).reshape(B, M, lv * lh)


def marginal_step(lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid):
    """Normalized conditional marginals of one site for all branches of
    B instances.

    lB (B, Np, lh, lv), drindex (B, Np), AT (B, D, lv, D), RL (B, M, D),
    RRsel (B, M, D, lh), lidx/uidx (B, M), nvalid (B,). Returns (Pn, mPn):
    probabilities (B, M, Np) normalized over the valid states, and the
    per-branch negativeness red flag (B, M). Plain torch throughout; the
    search path uses :func:`marginal_probf`, whose epilogue is a kernel.
    """
    T2 = _marginal_T2(AT, RL, RRsel)
    return _marginal.marginal_pn_plain(T2, lB, drindex, lidx, uidx, nvalid)


def marginal_probf(lBT, drindex, AT, RL, RRsel, lidx, uidx, nvalid, prob,
                   valid, log2_cutoff):
    """:func:`marginal_step` followed by the search's branch
    log2-probabilities and their per-instance reductions, with the
    Boltzmann table transposed (lBT (B, lh, lv, Np), see
    ``kernels.marginal.boltzmann_columns``). Returns probf (B, M, Np) =
    prob + log2(Pn), NEG for invalid branches or zero marginals, mPn
    (B, M), and pmax, mq, mqc (B,) as
    ``kernels.marginal.marginal_epilogue_plain`` defines them. Everything
    after the GEMMs is kernel K3 on CUDA."""
    T2 = _marginal_T2(AT, RL, RRsel)
    return _marginal.marginal_epilogue(T2, lBT, drindex, lidx, uidx, nvalid,
                                       prob, valid, log2_cutoff)


def rl_update(RL, AT, didx):
    """Absorb the active site into each branch's left environment:
    RL' = RL @ AT[:, d_m, :] with max-abs rescale. RL (B, M, D),
    AT (B, D, lv, D), didx (B, M)."""
    ATd = _take(AT.permute(0, 2, 1, 3), didx.long())      # (B, M, D, D)
    new = (RL[:, :, None, :] @ ATd)[:, :, 0]
    scale = new.abs().amax(dim=2, keepdim=True)
    return new / torch.where(scale > 0, scale, 1.0)
