"""Contraction engine: padded grid, PEPS row factory, boundary-MPS stack,
row environments and batched conditional marginals (torch).

Counterpart of ``tnax/engine.py``. A site's 5-leg PEPS tensor
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

from . import bmps
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


def build_rhoT(Wt, *, Dmax, tolS, tolV, max_sweeps, rsvd=True, omega=None):
    """Boundary-MPS stack from the bottom edge upward.

    Wt: (Ny, Nx, lh, lv, lh, lv) traced row tensors. Returns
    (rhoT, lognorms, overlaps, discarded); rhoT[ny] (ny=0..Ny) contracts
    rows ny..Ny-1 as an MPS over columns whose physical legs are the
    up-legs of row ny; rhoT[Ny] is the trivial boundary.
    """
    Ny, Nx, lh, lv = Wt.shape[:4]
    mps = mps0 = bmps.trivial_mps(Nx, Dmax, lv, Wt.dtype, Wt.device)
    As, lns, ovs, dss = [], [], [], []
    for ny in range(Ny - 1, -1, -1):
        mps, overlap, disc = bmps.compress_apply(
            mps, Wt[ny], Dmax, conj=True, tolS=tolS, tolV=tolV,
            max_sweeps=max_sweeps, rsvd=rsvd, omega=omega)
        As.append(mps.A)
        lns.append(mps.lognorm)
        ovs.append(overlap)
        dss.append(disc)
    rhoT = torch.stack(As[::-1] + [mps0.A])
    lognorms = torch.stack(lns[::-1] + [torch.zeros_like(mps0.lognorm)])
    return rhoT, lognorms, torch.stack(ovs[::-1]), torch.stack(dss[::-1])


def build_rho_both(Wt, *, Dmax, tolS, tolV, max_sweeps, rsvd=True,
                   omega=None):
    """Both boundary stacks (rhoT, rhoB).

    A bottom-boundary row absorption is a top-boundary absorption of the
    up/down-swapped tensor, and the forward build is the reverse build
    over the row-flipped stack, so rhoB is :func:`build_rhoT` of the
    mirrored rows. tnax runs the two lanes batched; here they run one
    after the other (each lane is bit-identical to the unbatched build
    in tnax too).
    """
    WtB = torch.flip(Wt.permute(0, 1, 2, 5, 4, 3), dims=(0,))
    kw = dict(Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
              rsvd=rsvd, omega=omega)
    rhoT = build_rhoT(Wt, **kw)[0]
    rhoBm = build_rhoT(WtB, **kw)[0]
    rhoB = torch.cat([rhoBm[-1:], torch.flip(rhoBm[:-1], dims=(0,))])
    return rhoT, rhoB


def _rr_absorb_twogemm(AT, Wt, u, rr):
    """One right-env absorption: contract rr with AT over the bond as one
    GEMM, contract that with the full traced tensor for every up-leg
    value q as a second GEMM, then select q = u_m per branch."""
    T = torch.einsum("mbr,adb->mrad", rr, AT)          # (M, lh, D, lv)
    new_all = torch.einsum("mrad,ldrq->malq", T, Wt)   # (M, D, lh, q)
    idx = u.long()[:, None, None, None].expand(new_all.shape[:3] + (1,))
    return torch.gather(new_all, 3, idx)[..., 0]


def row_right_envs(AT_row, Wt_row, uidx):
    """Right environments of the active row for every branch.

    AT_row (Nx, D, lv, D) boundary MPS below the row; Wt_row
    (Nx, lh, lv, lh, lv) traced tensors of the row; uidx (M, Nx) up-leg
    indices per branch per site. Returns RRs (Nx, M, D, lh): RRs[nx, m]
    is the environment of sites nx+1..Nx-1 (trivial at nx = Nx-1), each
    rescaled to max |entry| 1.
    """
    Nx, D, lv, _ = AT_row.shape
    lh = Wt_row.shape[1]
    M = uidx.shape[0]
    rr = torch.zeros((M, D, lh), dtype=AT_row.dtype, device=AT_row.device)
    rr[:, 0, 0] = 1.0
    RRs = [rr] * Nx
    for s in range(Nx - 1, 0, -1):
        new = _rr_absorb_twogemm(AT_row[s], Wt_row[s], uidx[:, s], rr)
        scale = new.abs().amax(dim=(1, 2), keepdim=True)
        rr = new / torch.where(scale > 0, scale, 1.0)
        RRs[s - 1] = rr
    return torch.stack(RRs)


def _marginal_T2(AT, RL, RRsel):
    """The two GEMMs of a marginal: (M, lv*lh) per-branch contractions."""
    M, D = RL.shape
    lv = AT.shape[1]
    T1 = (RL @ AT.reshape(D, lv * D)).reshape(M, lv, D)
    return torch.bmm(T1, RRsel).reshape(M, -1)          # (M, lv*lh)


def marginal_step(lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid):
    """Normalized conditional marginals of one site for all branches.

    lB (Np, lh, lv), drindex (Np,), AT (D, lv, D), RL (M, D),
    RRsel (M, D, lh), lidx/uidx (M,), nvalid (scalar). Returns (Pn, mPn):
    probabilities (M, Np) normalized over the valid states, and the
    per-branch negativeness red flag. Plain torch throughout; the search
    path uses :func:`marginal_probf`, whose epilogue is a kernel.
    """
    T2 = _marginal_T2(AT, RL, RRsel)
    return _marginal.marginal_pn_plain(T2, lB, drindex, lidx, uidx, nvalid)


def marginal_probf(lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid, prob,
                   valid):
    """:func:`marginal_step` followed by the search's branch
    log2-probabilities: returns probf (M, Np) = prob + log2(Pn), NEG for
    invalid branches or zero marginals, and mPn (M,). The elementwise
    epilogue after the GEMMs is kernel K3 on CUDA."""
    T2 = _marginal_T2(AT, RL, RRsel)
    return _marginal.marginal_epilogue(T2, lB, drindex, lidx, uidx, nvalid,
                                       prob, valid)


def rl_update(RL, AT, didx):
    """Absorb the active site into each branch's left environment:
    RL' = RL @ AT[:, d_m, :] with max-abs rescale. RL (M, D),
    AT (D, lv, D), didx (M,)."""
    ATd = AT.permute(1, 0, 2)[didx.long()]          # (M, D, D)
    new = torch.bmm(RL[:, None, :], ATd)[:, 0]
    scale = new.abs().amax(dim=1, keepdim=True)
    return new / torch.where(scale > 0, scale, 1.0)
