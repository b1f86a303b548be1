"""Balancing preconditioner on the device (the ladder of tnax.precondition).

Counterpart of ``tnax/precondition.py:280-516``. The vertical gauges of
every row interface are balanced with LAPACK-style diagonal scaling of
the bond environments between the top and bottom boundary MPS. tnax
vmaps :func:`_balance_one_interface` over the Ny-1 interfaces, and the
fleet vmaps that over its B instances; here the B * (Ny-1) interfaces
are one leading batch dimension ``i`` of every tensor, so each call of
:func:`gebal_scale` (kernel K1 on CUDA) balances all of them at once.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bmps, engine
from .kernels.gebal import gebal_scale


def _mix_left_j(RL, p, a):
    T = torch.einsum("icf,ifdg->icdg", RL, p)
    return torch.einsum("icdg,icdk->ikg", T, a)


def _mix_right_j(RR, p, a):
    T = torch.einsum("ifdg,igc->ifdc", p, RR)
    return torch.einsum("ifdc,ikdc->ifk", T, a)


def _bond_env_j(RL, p, a, RR):
    T1 = torch.einsum("icf,ifdg->icdg", RL, p)
    T2 = torch.einsum("icdg,igk->icdk", T1, RR)
    return torch.einsum("icdk,icek->ide", T2, a)


def _expectation_j(RL, RR, p, a):
    T1 = torch.einsum("icf,ifdg->icdg", RL, p)
    T2 = torch.einsum("icdg,igk->icdk", T1, RR)
    return torch.einsum("icdk,icdk->i", T2, a)


def _norm(x):
    """Frobenius norm per interface (leading dim)."""
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)


def _nrm(x):
    n = _norm(x)
    return torch.where(n > 0, n, 1.0)[:, None, None]


def _overlap_j(RL, RR, p, a):
    tiny = float(np.finfo(np.float32).tiny)
    return _expectation_j(RL, RR, p, a) \
        / torch.clamp(_norm(a) * _norm(p), min=tiny)


def _max_abs_normalized(C):
    m = C.abs().amax(dim=(1, 2), keepdim=True)
    return C / torch.where(m > 0, m, 1.0)


def _orth_right_j(A):
    """Right-orthogonalize one site per interface; returns (Q-form,
    centre) with the centre normalized by its max |entry|."""
    Ni, D, d, Dr = A.shape
    Q, R = bmps.qr_fixed(A.reshape(Ni, D, d * Dr).transpose(1, 2))
    C = _max_abs_normalized(R.transpose(1, 2))
    return Q.transpose(1, 2).reshape(Ni, -1, d, Dr)[:, :D], C


def _orth_left_j(A):
    Ni, D, d, Dr = A.shape
    Q, R = bmps.qr_fixed(A.reshape(Ni, D * d, Dr))
    return Q.reshape(Ni, D, d, -1)[..., :Dr], _max_abs_normalized(R)


def _balance_one_interface(B, T, nd, max_scale):
    """Both balancing sweeps of every row interface.

    B (Ni, Nx, D, lv, D): rhoB rows (self); T: rhoT rows (phi);
    nd (Ni, Nx) valid vertical leg dims. The stale/fresh environment
    choices, QR re-orthogonalizations and norm rescalings follow tnax
    step for step. Returns (scale2, scale3, o1_2, o2_2, o1_3, o2_3) with
    scale* (Ni, Nx, lv) and o* (Ni, Nx) in site order.
    """
    Ni, Nx, D, lv, _ = B.shape
    dtype, dev = B.dtype, B.device
    eye0 = torch.zeros((Ni, D, D), dtype=dtype, device=dev)
    eye0[:, 0, 0] = 1.0
    eyec = torch.eye(D, dtype=dtype, device=dev).expand(Ni, D, D)

    # pass 1: left environments with the raw tensors
    Lenvs = [eye0]
    for nx in range(Nx - 1):
        new = _mix_left_j(Lenvs[-1], T[:, nx], B[:, nx])
        Lenvs.append(new / _nrm(new))

    def balance(Bn, Tn, RL, RR, nx):
        env = _bond_env_j(RL, Tn, Bn, RR)
        scale = gebal_scale(env, nd[:, nx], max_scale)
        o1 = _overlap_j(RL, RR, Tn, Bn)
        Bn = Bn * scale[:, None, :, None]
        Tn = Tn / scale[:, None, :, None]
        return Bn, Tn, scale, o1, _overlap_j(RL, RR, Tn, Bn)

    # sweep 2: right-to-left, stale left envs, fresh right envs
    s2, o12, o22 = [None] * Nx, [None] * Nx, [None] * Nx
    B2, T2, Rstale = [None] * Nx, [None] * Nx, [eye0] * Nx
    RR, Cb, Ct = eye0, eyec, eyec
    for nx in range(Nx - 1, -1, -1):
        Bn = torch.einsum("iadb,ibc->iadc", B[:, nx], Cb)
        Tn = torch.einsum("iadb,ibc->iadc", T[:, nx], Ct)
        Bn, Tn, s2[nx], o12[nx], o22[nx] = balance(Bn, Tn, Lenvs[nx], RR, nx)
        if nx == 0:              # tnax skips the QR at the first site
            B2[0], T2[0] = Bn, Tn
            break
        B2[nx], Cb = _orth_right_j(Bn)
        T2[nx], Ct = _orth_right_j(Tn)
        RR = _mix_right_j(RR, T2[nx], B2[nx])
        RR = RR / _nrm(RR)
        Rstale[nx - 1] = RR

    # sweep 3: left-to-right, fresh left envs, stale right envs
    s3, o13, o23 = [None] * Nx, [None] * Nx, [None] * Nx
    RL, Cb, Ct = eye0, eyec, eyec
    for nx in range(Nx):
        Bn = torch.einsum("iab,ibdc->iadc", Cb, B2[nx])
        Tn = torch.einsum("iab,ibdc->iadc", Ct, T2[nx])
        Bn, Tn, s3[nx], o13[nx], o23[nx] = balance(Bn, Tn, RL, Rstale[nx],
                                                   nx)
        if nx == Nx - 1:
            break
        Bq, Cb = _orth_left_j(Bn)
        Tq, Ct = _orth_left_j(Tn)
        RL = _mix_left_j(RL, Tq, Bq)
        RL = RL / _nrm(RL)

    def st(xs):
        return torch.stack(xs, dim=1)

    return st(s2), st(s3), st(o12), st(o22), st(o13), st(o23)


def ladder_betas(beta, steps):
    """The ladder's rungs below the target beta: beta * 2**(n - steps)."""
    return [beta * 2.0 ** (nn - steps) for nn in range(steps)]


def ladder_max_scale(max_scale):
    """The clip of a rung's scales, the largest power of two at most
    sqrt(max_scale) (a rung's two sweeps multiply)."""
    return float(2.0 ** np.floor(np.log2(np.sqrt(max_scale))))


def overlaps_ud(overs):
    """tnax's ``overlaps_ud`` of one instance from the ladder's overlaps
    ``overs`` (R, 4, Ny-1, Nx) (host NumPy): per rung, the worst overlap
    before a balancing step and the better of it and the overlap after,
    over the sweeps' visiting order (right to left, then left to right;
    tnax precondition.py:626-640). Returns (2 R, Ny-1)."""
    R, _, Ni, Nx = overs.shape
    rows = []
    for r in range(R):
        o1_2, o2_2, o1_3, o2_3 = overs[r]
        overlaps = np.ones((2, Ni))
        for i in range(Ni):
            seq = [(o1_2[i, nx], o2_2[i, nx]) for nx in range(Nx - 1, -1, -1)]
            seq += [(o1_3[i, nx], o2_3[i, nx]) for nx in range(Nx)]
            for o1, o2 in seq:
                if o1 < overlaps[0, i]:
                    overlaps[0, i] = o1
                    overlaps[1, i] = max(o1, o2)
        rows.append(overlaps)
    return np.vstack(rows) if rows else np.empty((0, Ni))


def _ladder_program(Es, Esl, Esu, dmap, rmap, X0, betas, ndall, max_scale,
                    *, Dmax, tolS, tolV, max_sweeps, lh, lv, omega=None):
    """The balancing beta ladder of B instances: for each rung, the gauged
    Boltzmann tensors at its beta, both D=``Dmax`` boundary stacks (one
    build of 2B lanes), the sweeps of all B * (Ny-1) interfaces, and the
    scales folded into the gauges. The stacks zip up with the randomized
    sketch (``omega``, see ``bmps.zipup_apply``), as in tnax, whose ladder
    takes the ambient default.

    Tables and gauges carry the leading instance axis B; ``betas`` is a
    sequence of floats, ``ndall`` (B, Ny-1, Nx) the valid vertical leg
    dims. Returns (X, overlaps (B, R, 4, Ny-1, Nx)).
    """
    B, Ny, Nx = X0["Xd"].shape[:3]
    Ni = Ny - 1
    X = dict(X0)
    if Ni == 0:   # one row: no interface to balance, the gauges stay
        return X, X0["Xd"].new_zeros((B, len(betas), 4, 0, Nx))
    overs = []

    def interfaces(rho):
        # rows 1..Ny-1 of every instance, as one batch of B * Ni
        return rho[:, 1:Ny].reshape((B * Ni,) + rho.shape[2:])

    for beta in betas:
        _, Wt = engine.peps_rows(Es, Esl, Esu, dmap, rmap, X["Xl"], X["Xr"],
                                 X["Xu"], X["Xd"], beta, lh=lh, lv=lv)
        rhoT, rhoB = engine.build_rho_both(
            Wt, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
            rsvd=True, omega=omega)
        outs = _balance_one_interface(interfaces(rhoB), interfaces(rhoT),
                                      ndall.reshape(B * Ni, -1), max_scale)
        s2, s3, o1_2, o2_2, o1_3, o2_3 = (o.reshape((B, Ni) + o.shape[1:])
                                          for o in outs)
        s = s2 * s3                                     # (B, Ny-1, Nx, lv)
        Xd, Xu = X["Xd"].clone(), X["Xu"].clone()
        Xd[:, :-1] = Xd[:, :-1] * s
        Xu[:, 1:] = Xu[:, 1:] / s
        X = dict(X, Xd=Xd, Xu=Xu)
        overs.append(torch.stack([o1_2, o2_2, o1_3, o2_3], dim=1))
    return X, torch.stack(overs, dim=1)
