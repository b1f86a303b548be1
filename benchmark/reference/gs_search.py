"""Plain PyTorch ground-state search of a chimera spin glass: the
benchmark's reference for the ground-state cells.

It imports neither jax, tnax nor anything of tnax_torch, and takes nothing
the program made: it starts from the couplings. It follows the semantics
of tnac4o's search (Rams et al., PRE 104, 025308) in the plainest form:

- Cells of 8 spins are the sites of a 2D lattice. A cell state ``s`` in
  0..255 holds spin m in bit m; its vertical half ``v = s & 15`` (spins
  0-3) couples to the cell below, its horizontal half ``h = s >> 4``
  (spins 4-7) to the cell to the right.
- The Gibbs weight at ``beta`` is contracted row by row from the bottom
  into boundary MPSs of bond ``Dmax``: each row is applied to the MPS
  below it by a zip-up with exact SVDs, from a right-canonical MPS, then
  one-site variational sweeps. There is no gauge and no sketch.
- A beam search visits the cells row by row, left to right. Every branch's
  conditional marginal of the next cell comes from its left environment,
  the MPS below and its own right environments. Candidates below
  ``relative_P_cutoff`` times the best are dropped. Candidates whose
  boundary (the vertical halves that the rows below see, the horizontal
  half of the last cell and the row above's halves still to be used)
  agree are merged: the lowest energy represents them, the degeneracies
  of those within ``min_dEng`` of it add up and their log2-probabilities
  are averaged. The ``M`` most probable groups survive.

Energies are exact float64 sums of the couplings; the contractions run in
``dtype``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

CELL = 8
NS = 2 ** CELL     # states of a cell
NH = 16            # states of a half cell


def _sigma(nbits):
    """(2**nbits, nbits) spins +-1 of every bit pattern."""
    b = (np.arange(2 ** nbits)[:, None] >> np.arange(nbits)[None, :]) & 1
    return 2.0 * b - 1.0


@dataclasses.dataclass
class Lattice:
    """Energy tables of an n x n chimera instance (float64, NumPy):
    ``Eloc`` (n, n, 256) inside each cell, ``Ev`` (n, n, 16, 16) between
    the vertical half ``u`` of the cell above and ``v`` of this cell,
    ``Eh`` (n, n, 16, 16) between the horizontal half ``l`` of the cell to
    the left and ``h`` of this cell; ``dmask`` / ``rmask`` (n, n) the
    bits of ``v`` / ``h`` coupled to the cell below / to the right."""
    n: int
    Eloc: np.ndarray
    Ev: np.ndarray
    Eh: np.ndarray
    dmask: np.ndarray
    rmask: np.ndarray


def lattice(n, coupl):
    """The :class:`Lattice` of chimera C(n) with 0-based couplings
    ``coupl``; ValueError for a coupling that chimera does not have."""
    Jin = np.zeros((n, n, CELL, CELL))
    Jv = np.zeros((n, n, 4, 4))
    Jh = np.zeros((n, n, 4, 4))
    dmask = np.zeros((n, n), np.int64)
    rmask = np.zeros((n, n), np.int64)
    for i, j, val in coupl:
        i, j = min(i, j), max(i, j)
        ci, cj, a, b = i // CELL, j // CELL, i % CELL, j % CELL
        yi, xi = divmod(ci, n)
        yj, xj = divmod(cj, n)
        if ci == cj:
            Jin[yi, xi, a, b] += val
        elif (yj, xj) == (yi + 1, xi) and a < 4 and b < 4:
            Jv[yj, xj, a, b] += val
            dmask[yi, xi] |= 1 << a
        elif (yj, xj) == (yi, xi + 1) and a >= 4 and b >= 4:
            Jh[yj, xj, a - 4, b - 4] += val
            rmask[yi, xi] |= 1 << (a - 4)
        else:
            raise ValueError(f"coupling ({i}, {j}) is not an edge of "
                             f"chimera C({n})")
    S8, S4 = _sigma(CELL), _sigma(4)
    upper = np.triu(np.ones((CELL, CELL)), 1)
    Eloc = np.einsum("sa,yxab,sb->yxs", S8, Jin * upper, S8) \
        + np.einsum("sa,yxa->yxs", S8, np.diagonal(Jin, axis1=2, axis2=3))
    Ev = np.einsum("ua,yxab,vb->yxuv", S4, Jv, S4)
    Eh = np.einsum("la,yxab,hb->yxlh", S4, Jh, S4)
    return Lattice(n, Eloc, Ev, Eh, dmask, rmask)


def weights(lat, beta, dtype, device):
    """The row tensors W (n, n, u, l, h, v) = exp(-beta (Eloc + Ev + Eh)),
    each site shifted by its lowest energy."""
    n = lat.n
    # s = v | h << 4, so Eloc reshaped is indexed [h, v]
    Ehv = lat.Eloc.reshape(n, n, NH, NH)
    E = Ehv[:, :, None, None, :, :] + lat.Ev[:, :, :, None, None, :] \
        + lat.Eh[:, :, None, :, :, None]
    E = E - E.min(axis=(2, 3, 4, 5), keepdims=True)
    return torch.as_tensor(np.exp(-beta * E), dtype=dtype, device=device)


def _right_canonical(mps):
    """``mps`` (list of (l, p, r)) in right-canonical form, the norm in
    the first site, which is normalised."""
    mps = list(mps)
    for x in range(len(mps) - 1, 0, -1):
        l, p, r = mps[x].shape
        q, rr = torch.linalg.qr(mps[x].reshape(l, p * r).T)
        k = q.shape[1]
        mps[x] = q.T.reshape(k, p, r)
        mps[x - 1] = torch.einsum("apb,cb->apc", mps[x - 1], rr)
    mps[0] = mps[0] / torch.linalg.norm(mps[0])
    return mps


def row_sites(W_row, below):
    """The sites (A, u, B) of a row applied to the MPS ``below``: bond
    (a, l) on the left and (b, h) on the right, where a, b are the MPS's
    bonds and l, h the row's horizontal halves (summed at the right
    end)."""
    n = len(below)
    sites = []
    for x in range(n):
        Wx = W_row[x]                                     # (u, l, h, v)
        if x == 0:
            Wx = Wx[:, :1]
        if x == n - 1:
            Wx = Wx.sum(dim=2, keepdim=True)
        a, _, b = below[x].shape
        l, h = Wx.shape[1], Wx.shape[2]
        sites.append(torch.einsum("avb,ulhv->alubh", below[x], Wx)
                     .reshape(a * l, NH, b * h))
    return sites


def zip_up(sites, Dmax):
    """The MPS ``sites`` truncated to ``Dmax`` left to right: at each site
    the ``Dmax`` leading left singular vectors, as eigenvectors of the
    Gram matrix (formed in the contraction's dtype, diagonalised in
    float64); left-canonical, the norm in the last site, normalised."""
    C = torch.ones((1, 1), dtype=sites[0].dtype, device=sites[0].device)
    out = []
    for x, N in enumerate(sites):
        A, _, B = N.shape
        k = C.shape[0]
        T = (C @ N.reshape(A, NH * B)).reshape(k * NH, B)
        if x == len(sites) - 1:
            out.append((T / torch.linalg.norm(T)).reshape(k, NH, B))
            break
        _, U = torch.linalg.eigh((T @ T.T).double())
        r = min(Dmax, U.shape[1], B)
        U = U[:, -r:].flip(1).to(T.dtype)
        out.append(U.reshape(k, NH, r))
        C = U.T @ T
        C = C / torch.linalg.norm(C)
    return out


def variational(sites, chi, sweeps):
    """One-site variational sweeps of the MPS ``chi`` (left-canonical) to
    the MPS ``sites``: each site in turn is the contraction of its
    environments with the target, then orthonormalised by a QR in the
    sweep's direction. Ends left-canonical, normalised."""
    n = len(sites)
    dt, dev = chi[0].dtype, chi[0].device
    one = torch.ones((1, 1), dtype=dt, device=dev)

    def unit(t):
        return t / torch.linalg.norm(t)

    L = [one] + [None] * (n - 1)
    for x in range(n - 1):
        L[x + 1] = unit(torch.einsum("da,dup,aub->pb", L[x], chi[x],
                                     sites[x]))
    R = [None] * (n - 1) + [one]
    for _ in range(sweeps):
        for x in range(n - 1, 0, -1):
            M = torch.einsum("da,aub,eb->due", L[x], sites[x], R[x])
            d, _, e = M.shape
            Q, _ = torch.linalg.qr(M.reshape(d, NH * e).T)
            chi[x] = Q.T.reshape(-1, NH, e)
            R[x - 1] = unit(torch.einsum("dup,aub,pb->da", chi[x],
                                         sites[x], R[x]))
        for x in range(n - 1):
            M = torch.einsum("da,aub,eb->due", L[x], sites[x], R[x])
            d, _, e = M.shape
            Q, _ = torch.linalg.qr(M.reshape(d * NH, e))
            chi[x] = Q.reshape(d, NH, -1)
            L[x + 1] = unit(torch.einsum("da,dup,aub->pb", L[x], chi[x],
                                         sites[x]))
        chi[n - 1] = unit(torch.einsum("da,aub,eb->due", L[n - 1],
                                       sites[n - 1], R[n - 1]))
    return chi


def apply_row(W_row, below, Dmax, sweeps=2):
    """The boundary MPS of a row applied to the MPS ``below`` (physical
    leg: this row's vertical halves), zipped up with exact SVDs from a
    right-canonical ``below``, truncated to ``Dmax``, then ``sweeps``
    variational sweeps; its physical leg is the row above's vertical
    halves."""
    sites = row_sites(W_row, _right_canonical(below))
    return variational(sites, zip_up(sites, Dmax), sweeps)


def boundary(W, Dmax, sweeps=2):
    """env[y] for y = 1..Ny: the rows y..Ny-1 contracted into an MPS
    whose physical leg is row y-1's vertical halves; env[Ny] sums the
    last row's vertical halves."""
    n = W.shape[0]
    ones = torch.ones((1, NH, 1), dtype=W.dtype, device=W.device)
    env = {n: [ones] * n}
    for y in range(n - 1, 0, -1):
        env[y] = apply_row(W[y], env[y + 1], Dmax, sweeps)
    return env


@dataclasses.dataclass
class Result:
    energy: float          # exact float64 energy of the best state
    degeneracy: int
    log2p: float           # its log2-probability
    cells: np.ndarray      # (n * n,) cell states, row-major
    bits: np.ndarray       # (8 * n * n,) spins, 1 = up


def _normalise(t, dims):
    m = t.abs().amax(dim=dims, keepdim=True)
    return t / torch.where(m > 0, m, torch.ones_like(m))


def search(n, coupl, beta=3.0, Dmax=48, M=1024, relative_P_cutoff=1e-8,
           min_dEng=1e-12, dtype=torch.float64, device="cpu", sweeps=2):
    """The most probable state of chimera C(n) with couplings ``coupl``
    (0-based, see :func:`lattice`) at ``beta``: its exact energy,
    degeneracy, log2-probability and spins."""
    device = torch.device(device)
    lat = lattice(n, coupl)
    W = weights(lat, beta, dtype, device)
    env = boundary(W, Dmax, sweeps)
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt,  # noqa
                                                    device=device)
    Eloc, Ev, Eh = t(lat.Eloc), t(lat.Ev), t(lat.Eh)
    dmask, rmask = t(lat.dmask, torch.int64), t(lat.rmask, torch.int64)
    log2_cut = math.log2(relative_P_cutoff) if relative_P_cutoff > 0 \
        else -math.inf
    s_all = torch.arange(NS, device=device)
    vind = torch.zeros((1, n + 1), dtype=torch.int64, device=device)
    Eng = torch.zeros(1, dtype=torch.float64, device=device)
    prob = torch.zeros(1, dtype=torch.float64, device=device)
    deg = torch.ones(1, dtype=torch.int64, device=device)
    cells = torch.zeros((1, n * n), dtype=torch.int64, device=device)
    for y in range(n):
        below = env[y + 1]
        K = vind.shape[0]
        # right environments R[x] (K, a, l) of cells x..n-1 of the row
        R = [None] * (n + 1)
        R[n] = torch.ones((K, 1, NH), dtype=dtype, device=device)
        for x in range(n - 1, 0, -1):
            a, _, b = below[x].shape
            Y = torch.matmul(below[x].reshape(a * NH, b)[None], R[x + 1])
            Wm = W[y, x][vind[:, x + 1]]                    # (K, l, h, v)
            Y = Y.reshape(K, a, NH, NH).transpose(2, 3)    # (K, a, h, v)
            R[x] = _normalise(torch.matmul(
                Y.reshape(K, a, NH * NH),
                Wm.reshape(K, NH, NH * NH).transpose(1, 2)), (1, 2))
        L = torch.ones((K, 1), dtype=dtype, device=device)
        for x in range(n):
            K = vind.shape[0]
            a, _, b = below[x].shape
            l, u = vind[:, x], vind[:, x + 1]
            Z = (L @ below[x].reshape(a, NH * b)).reshape(K, NH, b)
            Q = torch.matmul(Z, R[x + 1])                   # (K, v, h)
            marg = W[y, x][u, l].transpose(1, 2) * Q        # (K, v, h)
            # cell state s = v | h << 4: index h * 16 + v
            marg = marg.transpose(1, 2).reshape(K, NS).to(torch.float64)
            p = marg / marg.sum(dim=1, keepdim=True)
            logp = torch.where(p > 0, torch.log2(p.clamp_min(1e-300)),
                               -math.inf) + prob[:, None]
            flat = logp.reshape(-1)
            keep = flat > flat.max() + log2_cut
            keep[flat.argmax()] = True
            idx = keep.nonzero()[:, 0]
            par, s = idx // NS, s_all[idx % NS]
            v, h = s & 15, s >> 4
            Ec = Eng[par] + Eloc[y, x][s] + Ev[y, x][u[par], v] \
                + Eh[y, x][l[par], h]
            pc = flat[idx]
            vn = vind[par].clone()
            vn[:, x] = v & dmask[y, x]
            vn[:, x + 1] = h & rmask[y, x]
            uniq, inv = torch.unique(vn, dim=0, return_inverse=True)
            G, C = uniq.shape[0], idx.shape[0]
            Emin = torch.full((G,), math.inf, dtype=torch.float64,
                              device=device).scatter_reduce(
                0, inv, Ec, "amin")
            sel = (Ec - Emin[inv]) <= min_dEng
            degG = torch.zeros(G, dtype=torch.int64, device=device) \
                .scatter_add(0, inv, torch.where(sel, deg[par], 0))
            nsel = torch.zeros(G, dtype=torch.float64, device=device) \
                .scatter_add(0, inv, sel.to(torch.float64))
            probG = torch.zeros(G, dtype=torch.float64, device=device) \
                .scatter_add(0, inv, torch.where(sel, pc, 0.0)) / nsel
            pos = torch.arange(C, device=device)
            first = torch.where(Ec == Emin[inv], pos, C)
            rep = torch.full((G,), C, dtype=torch.int64, device=device) \
                .scatter_reduce(0, inv, first, "amin")
            top = torch.topk(probG, M).indices if G > M \
                else torch.arange(G, device=device)
            r = rep[top]
            vind, Eng, prob, deg = uniq[top], Ec[r], probG[top], degG[top]
            cells = cells[par[r]]
            cells[:, y * n + x] = s[r]
            L = _normalise(Z[par[r], v[r]], (1,))
            R = [None if R[z] is None or z <= x + 1 else R[z][par[r]]
                 for z in range(n + 1)]
        vind = torch.cat([torch.zeros_like(vind[:, :1]), vind[:, :-1]], 1)
    best = int(torch.argmin(Eng))
    cells_np = cells[best].cpu().numpy()
    bits = ((cells_np[:, None] >> np.arange(CELL)[None, :]) & 1).reshape(-1)
    return Result(float(Eng[best]), int(deg[best]), float(prob[best]),
                  cells_np, bits.astype(np.int8))
