"""Balancing preconditioner for the PEPS gauges (tnax.precondition).

At a ladder of smaller betas, cheap (D=8) boundary MPS are built from
both sides of every interface, and the mixed bond environments there are
equilibrated with LAPACK-style diagonal balancing, the scales absorbed
into the gauges. Two implementations of the up-down ('ud') direction
share tnax's semantics:

- the host sweeps (:func:`ud_host`, tnax's ``balance_ud``): both row
  stacks built on the device, read once to the host in float64 and swept
  in NumPy with ``scipy.linalg.matrix_balance``, as tnax does on the CPU;
  the left-right ('lr') direction (:func:`lr_host`, tnax's
  ``balance_lr``) runs the same way over the column stacks, with tnax's
  conditional accept;
- the device ladder (:func:`_ladder_program`): tnax vmaps
  :func:`_balance_one_interface` over the Ny-1 interfaces, and the fleet
  vmaps that over its B instances; here the B * (Ny-1) interfaces are one
  leading batch dimension ``i`` of every tensor, so each call of
  :func:`gebal_scale` (kernel K1 on CUDA) balances all of them at once.

The core functions take the instance axis B (tables from
``search.fleet_tables`` or :func:`problem_tables`, gauges as (B, Ny, Nx,
l) tensors). tnax's named functions (:func:`balance_ud`,
:func:`balance_lr`, :func:`balance_ud_device`,
:func:`precondition_ladder_device`, :func:`precondition_fleet`) take its
arguments (problems and host gauge dicts, which they return as float64
arrays) plus ``device``, ``dtype`` and the zip-up sketch ``omega``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from . import bmps, config, engine, search
from .kernels.gebal import gebal_scale


# -- the host sweeps: NumPy copies of tnax's helpers (padded arrays) -------

def _qr_fixed(M):
    Q, R = np.linalg.qr(M, mode="reduced")
    s = np.sign(np.diagonal(R))
    s[s == 0] = 1
    return Q * s[None, :], R * s[:, None]


def _orth_right_absorb(A, n):
    """Right-orthogonalize site n, absorbing the centre into site n-1."""
    Dl, d, Dr = A[n].shape
    Q, R = _qr_fixed(A[n].reshape(Dl, d * Dr).T)
    A[n] = Q.T.reshape(Dl, d, Dr)
    C = R.T
    nf = np.max(np.abs(C))
    if nf > 0:
        C = C / nf
    A[n - 1] = np.einsum("adb,bc->adc", A[n - 1], C)


def _orth_left_absorb(A, n):
    """Left-orthogonalize site n, absorbing the centre into site n+1."""
    Dl, d, Dr = A[n].shape
    Q, R = _qr_fixed(A[n].reshape(Dl * d, Dr))
    A[n] = Q.reshape(Dl, d, Dr)
    nf = np.max(np.abs(R))
    if nf > 0:
        R = R / nf
    A[n + 1] = np.einsum("ab,bdc->adc", R, A[n + 1])


def _mix_left(RL, p, a):
    T = np.einsum("cf,fdg->cdg", RL, p)
    return np.einsum("cdg,cdk->kg", T, a)


def _mix_right(RR, p, a):
    T = np.einsum("fdg,gc->fdc", p, RR)
    return np.einsum("fdc,kdc->fk", T, a)


def _bond_env(RL, p, a, RR):
    """Mixed environment of the physical legs at one site, (d_phi,
    d_self)."""
    T1 = np.einsum("cf,fdg->cdg", RL, p)    # (self_l, d_phi, phi_r)
    T2 = np.einsum("cdg,gk->cdk", T1, RR)   # (self_l, d_phi, self_r)
    return np.einsum("cdk,cek->de", T2, a)


def _expectation(RL, RR, p, a):
    T1 = np.einsum("cf,fdg->cdg", RL, p)
    T2 = np.einsum("cdg,gk->cdk", T1, RR)
    return np.einsum("cdk,cdk->", T2, a)


def _balance_scale(env, max_scale):
    """LAPACK's diagonal balancing scales (powers of two), clipped."""
    _, (scale, _) = scipy.linalg.matrix_balance(env, permute=False,
                                                separate=True)
    return np.minimum(np.maximum(scale, 1.0 / max_scale), max_scale)


def _norm(A):
    return np.linalg.norm(A)


def _e00(D):
    e = np.zeros((D, D))
    e[0, 0] = 1.0
    return e


def _sweep_ud(rhoT, rhoB, X, ldims, lv, max_scale):
    """tnax's ``balance_ud`` sweeps of one instance on the host: rhoT,
    rhoB (Ny+1, Nx, D, lv, D) float64 stacks, X the float64 gauges
    (updated in place), ldims (Ny, Nx) the valid vertical leg dims.
    Returns the worst normalized mixed overlaps before and after
    rescaling per interface, (2, Ny-1)."""
    Ny, Nx = rhoT.shape[0] - 1, rhoT.shape[1]
    overlaps = np.ones((2, max(Ny - 1, 0)))
    for ny in range(1, Ny):
        # self = rhoB[ny] (rows above), phi = rhoT[ny] (rows below); both
        # have physical legs on the up-legs of row ny
        B = [rhoB[ny, nx].copy() for nx in range(Nx)]
        T = [rhoT[ny, nx].copy() for nx in range(Nx)]
        D = B[0].shape[0]
        R = [None] * (Nx + 1)
        R[0] = _e00(D)
        for nx in range(Nx):
            R[nx + 1] = _mix_left(R[nx], T[nx], B[nx])
            nrm = np.linalg.norm(R[nx + 1])
            if nrm > 0:
                R[nx + 1] = R[nx + 1] / nrm

        def _rebalance(nx, RL, RR):
            nd = ldims[ny - 1, nx]
            env = _bond_env(RL, T[nx], B[nx], RR)[:nd, :nd]
            scale = _balance_scale(env, max_scale)
            full = np.ones(lv)
            full[:nd] = scale
            o1 = _expectation(RL, RR, T[nx], B[nx]) \
                / max(_norm(B[nx]) * _norm(T[nx]), 1e-300)
            B[nx] *= full[None, :, None]
            T[nx] *= (1.0 / full)[None, :, None]
            o2 = _expectation(RL, RR, T[nx], B[nx]) \
                / max(_norm(B[nx]) * _norm(T[nx]), 1e-300)
            if o1 < overlaps[0, ny - 1]:
                overlaps[0, ny - 1] = o1
                overlaps[1, ny - 1] = max(o1, o2)
            X["Xd"][ny - 1, nx, :nd] *= scale
            X["Xu"][ny, nx, :nd] *= 1.0 / scale

        # right-to-left sweep
        R[Nx] = _e00(D)
        for nx in range(Nx - 1, -1, -1):
            _rebalance(nx, R[nx], R[nx + 1])
            if nx > 0:
                _orth_right_absorb(B, nx)
                _orth_right_absorb(T, nx)
                R[nx] = _mix_right(R[nx + 1], T[nx], B[nx])
                nrm = np.linalg.norm(R[nx])
                if nrm > 0:
                    R[nx] = R[nx] / nrm
        # left-to-right sweep
        for nx in range(Nx):
            _rebalance(nx, R[nx], R[nx + 1])
            if nx < Nx - 1:
                _orth_left_absorb(B, nx)
                _orth_left_absorb(T, nx)
                R[nx + 1] = _mix_left(R[nx], T[nx], B[nx])
                nrm = np.linalg.norm(R[nx + 1])
                if nrm > 0:
                    R[nx + 1] = R[nx + 1] / nrm
    return overlaps


def _sweep_lr(rhoL, rhoR, X, hdims, lh, max_scale):
    """tnax's ``balance_lr`` sweeps of one instance on the host: rhoL,
    rhoR (Nx+1, Ny, D, lh, D) float64 stacks, X the float64 gauges
    (updated in place), hdims (Ny, Nx) the valid horizontal leg dims. A
    scale is kept only where it raises the normalized mixed overlap,
    else reverted, as in tnax."""
    Nx, Ny = rhoL.shape[0] - 1, rhoL.shape[1]
    for nx in range(1, Nx):
        # self = rhoL[nx] (columns left), phi = rhoR[nx] (columns right);
        # both have physical legs on the left-legs of column nx, and the
        # chain index is the row ny
        Lc = [rhoL[nx, ny].copy() for ny in range(Ny)]
        Rc = [rhoR[nx, ny].copy() for ny in range(Ny)]
        D = Lc[0].shape[0]
        R = [None] * (Ny + 1)
        R[0] = _e00(D)
        for ny in range(Ny):
            R[ny + 1] = _mix_left(R[ny], Rc[ny], Lc[ny])

        def _try_rebalance(ny, RL, RR):
            nd = hdims[ny, nx - 1]
            env = _bond_env(RL, Rc[ny], Lc[ny], RR)[:nd, :nd]
            scale = _balance_scale(env, max_scale)
            full = np.ones(lh)
            full[:nd] = scale
            o1 = _expectation(RL, RR, Rc[ny], Lc[ny]) \
                / max(_norm(Lc[ny]) * _norm(Rc[ny]), 1e-300)
            Lc[ny] *= full[None, :, None]
            Rc[ny] *= (1.0 / full)[None, :, None]
            o2 = _expectation(RL, RR, Rc[ny], Lc[ny]) \
                / max(_norm(Lc[ny]) * _norm(Rc[ny]), 1e-300)
            if o2 > o1:
                X["Xr"][ny, nx - 1, :nd] *= scale
                X["Xl"][ny, nx, :nd] *= 1.0 / scale
            else:
                Lc[ny] *= (1.0 / full)[None, :, None]
                Rc[ny] *= full[None, :, None]

        R[Ny] = _e00(D)
        for ny in range(Ny - 1, -1, -1):
            _try_rebalance(ny, R[ny], R[ny + 1])
            if ny > 0:
                _orth_right_absorb(Lc, ny)
                _orth_right_absorb(Rc, ny)
                R[ny] = _mix_right(R[ny + 1], Rc[ny], Lc[ny])
        for ny in range(Ny):
            _try_rebalance(ny, R[ny], R[ny + 1])
            if ny < Ny - 1:
                _orth_left_absorb(Lc, ny)
                _orth_left_absorb(Rc, ny)
                R[ny + 1] = _mix_left(R[ny], Rc[ny], Lc[ny])


def _host64(x):
    """A device tensor as a float64 NumPy array: one read, timed by a
    recording stage clock."""
    rec = config.recording()
    if rec is None:
        return x.to("cpu", torch.float64).numpy()
    return rec.read(x.to, "cpu", torch.float64).numpy()


def _host_sweeps(stage, f, beta, X, *, Dmax, tolS, tolV, max_sweeps,
                 max_scale, omega, clock):
    """One host balancing sweep ("ud" or "lr") of B instances: the gauged
    rows at ``beta``, the direction's two stacks built on the device (one
    build of 2B lanes), read once to the host in float64, then the
    direction's sweep per instance in NumPy over its stacks, its float64
    gauges and its problem's valid leg dims. The gauges return to the
    device in their dtype: every scale is a power of two, so the products
    stay exact. Returns (X, the sweeps' outputs per instance)."""
    build, sweep, dims, leg = {
        "ud": (engine.build_rho_both, _sweep_ud, "ld", f["lv"]),
        "lr": (engine.build_rho_lr, _sweep_lr, "lr", f["lh"])}[stage]
    if clock is None:
        clock = config.StageClock(None, f["device"])
    _, Wt = engine.peps_rows(f["Es"], f["Esl"], f["Esu"], f["dmap"],
                             f["rmap"], X["Xl"], X["Xr"], X["Xu"], X["Xd"],
                             beta, lh=f["lh"], lv=f["lv"])
    a, b = build(Wt, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
                 rsvd=True, omega=omega)
    a, b = _host64(a), _host64(b)
    clock.lap(f"{stage} builds")
    Xh = {k: _host64(v) for k, v in X.items()}
    outs = [sweep(a[i], b[i], {k: v[i] for k, v in Xh.items()},
                  getattr(p, dims), leg, max_scale)
            for i, p in enumerate(f["problems"])]
    X = {k: torch.as_tensor(v, device=X[k].device).to(X[k].dtype)
         for k, v in Xh.items()}
    clock.lap(f"{stage} sweeps")
    return X, outs


def ud_host(f, beta, X, *, Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20,
            max_scale=32.0, omega=None, clock=None):
    """tnax's ``balance_ud`` for B instances: rhoT and rhoB from one
    device build (``engine.build_rho_both``, zip-up with the sketch
    ``omega``), the interface sweeps on the host. ``f`` is the instances'
    tables (``search.fleet_tables``), X their gauges (B, Ny, Nx, l),
    ``max_scale`` the clip (:func:`ladder_max_scale`), ``clock`` a
    ``config.StageClock`` that gets "ud builds" and "ud sweeps".
    Returns (X, overlaps (B, 2, Ny-1), tnax's ``overlaps_ud`` rows)."""
    X, outs = _host_sweeps("ud", f, beta, X, Dmax=Dmax, tolS=tolS,
                           tolV=tolV, max_sweeps=max_sweeps,
                           max_scale=max_scale, omega=omega, clock=clock)
    return X, np.stack(outs)


def lr_host(f, beta, X, *, Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20,
            max_scale=32.0, omega=None, clock=None):
    """tnax's ``balance_lr`` for B instances: rhoL and rhoR from one
    device build (``engine.build_rho_lr``), the column-interface sweeps
    on the host with tnax's conditional accept. Arguments as
    :func:`ud_host`; ``clock`` gets "lr builds" and "lr sweeps". Returns
    X."""
    X, _ = _host_sweeps("lr", f, beta, X, Dmax=Dmax, tolS=tolS, tolV=tolV,
                        max_sweeps=max_sweeps, max_scale=max_scale,
                        omega=omega, clock=clock)
    return X


# -- the device ladder -------------------------------------------------------


# The environment updates are bmps's (_mix_left, _mix_right, _project),
# batched here over the interface axis i.

def _bond_env_j(RL, p, a, RR):
    return torch.einsum("icdk,icek->ide", bmps._project(RL, p, RR), a)


def _expectation_j(RL, RR, p, a):
    return torch.einsum("icdk,icdk->i", bmps._project(RL, p, RR), a)


def _norm_j(x):
    """Frobenius norm per interface (leading dim)."""
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)


def _nrm(x):
    n = _norm_j(x)
    return torch.where(n > 0, n, 1.0)[:, None, None]


def _overlap_j(RL, RR, p, a):
    tiny = float(np.finfo(np.float32).tiny)
    return _expectation_j(RL, RR, p, a) \
        / torch.clamp(_norm_j(a) * _norm_j(p), min=tiny)


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
        new = bmps._mix_left(Lenvs[-1], T[:, nx], B[:, nx])
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
        RR = bmps._mix_right(RR, T2[nx], B2[nx])
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
        RL = bmps._mix_left(RL, Tq, Bq)
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
    dims. A recording stage clock gets each rung's three sub-spans:
    "ladder/peps" (the tensors), "ladder/build" (the stacks) and
    "ladder/balance" (the sweeps and the gauges' update). Returns (X,
    overlaps (B, R, 4, Ny-1, Nx)).
    """
    B, Ny, Nx = X0["Xd"].shape[:3]
    Ni = Ny - 1
    X = dict(X0)
    if Ni == 0:   # one row: no interface to balance, the gauges stay
        return X, X0["Xd"].new_zeros((B, len(betas), 4, 0, Nx))
    overs = []
    rec = config.recording()

    def interfaces(rho):
        # rows 1..Ny-1 of every instance, as one batch of B * Ni
        return rho[:, 1:Ny].reshape((B * Ni,) + rho.shape[2:])

    for beta in betas:
        _, Wt = engine.peps_rows(Es, Esl, Esu, dmap, rmap, X["Xl"], X["Xr"],
                                 X["Xu"], X["Xd"], beta, lh=lh, lv=lv)
        if rec is not None:
            rec.leaf("ladder/peps")
        rhoT, rhoB = engine.build_rho_both(
            Wt, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
            rsvd=True, omega=omega)
        if rec is not None:
            rec.leaf("ladder/build")
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
        if rec is not None:
            rec.leaf("ladder/balance")
    return X, torch.stack(overs, dim=1)


# -- tnax's named functions: problems and host gauges in, host gauges out ----

def _tables(problems, device, dtype):
    device, dtype = config.resolve(device, dtype)
    return search.problem_tables(problems, 0.0, device, dtype)


def _to_device(gauges_list, f):
    """Host gauge dicts, one per instance -> (B, Ny, Nx, l) tensors."""
    return {k: torch.as_tensor(np.stack([np.asarray(X[k]) for X in
                                         gauges_list]), device=f["device"])
            .to(f["dtype"]) for k in ("Xl", "Xr", "Xu", "Xd")}


def _to_host(X):
    """(B, ...) gauge tensors -> one float64 host dict per instance."""
    Xh = {k: _host64(v) for k, v in X.items()}
    return [{k: v[b] for k, v in Xh.items()}
            for b in range(Xh["Xd"].shape[0])]


def _ladder(f, betas, X, *, Dmax, tolS, tolV, max_sweeps, max_scale,
            omega):
    return _ladder_program(f["Es"], f["Esl"], f["Esu"], f["dmap"],
                           f["rmap"], X, list(betas), f["ndall"],
                           ladder_max_scale(max_scale), Dmax=Dmax,
                           tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
                           lh=f["lh"], lv=f["lv"], omega=omega)


def balance_ud(problem, beta, gauges, Dmax=8, graduate_truncation=False,
               tolS=1e-16, tolV=1e-10, max_sweeps=20, max_scale=1024,
               overlaps_out=None, *, device=None, dtype=None, omega=None):
    """One up-down balancing sweep at ``beta`` (tnax's ``balance_ud``):
    the stacks on ``device`` (CUDA unless given) in ``dtype``, the sweeps
    on the host (:func:`ud_host`). ``graduate_truncation`` has no effect
    on the zip-up. Returns the updated gauges dict (float64 host arrays;
    Xd[ny-1]*Xu[ny] == 1 kept); appends a (2, Ny-1) array of the worst
    normalized mixed overlaps before/after rescaling per interface to
    ``overlaps_out`` if it is a list."""
    f = _tables([problem], device, dtype)
    X, ov = ud_host(f, beta, _to_device([gauges], f), Dmax=Dmax, tolS=tolS,
                    tolV=tolV, max_sweeps=max_sweeps,
                    max_scale=ladder_max_scale(max_scale), omega=omega)
    if overlaps_out is not None:
        overlaps_out.append(ov[0])
    return _to_host(X)[0]


def balance_lr(problem, beta, gauges, Dmax=8, graduate_truncation=False,
               tolS=1e-16, tolV=1e-10, max_sweeps=20, max_scale=1024, *,
               device=None, dtype=None, omega=None):
    """One left-right balancing sweep at ``beta`` (tnax's
    ``balance_lr``; :func:`lr_host`). ``graduate_truncation`` has no
    effect on the zip-up. Returns the updated gauges dict
    (Xr[:, nx-1]*Xl[:, nx] == 1 kept)."""
    f = _tables([problem], device, dtype)
    X = lr_host(f, beta, _to_device([gauges], f), Dmax=Dmax, tolS=tolS,
                tolV=tolV, max_sweeps=max_sweeps,
                max_scale=ladder_max_scale(max_scale), omega=omega)
    return _to_host(X)[0]


def precondition_ladder_device(problem, betas, gauges, Dmax=8,
                               graduate_truncation=False, tolS=1e-16,
                               tolV=1e-10, max_sweeps=20, max_scale=1024,
                               overlaps_out=None, dtype=None, *,
                               device=None, omega=None):
    """The whole 'ud' beta ladder on the device (:func:`_ladder_program`,
    K1 on CUDA), tnax's function of that name: per rung the semantics of
    :func:`balance_ud`. ``graduate_truncation`` has no effect on the
    zip-up. Appends one (2, Ny-1) overlaps array per rung to
    ``overlaps_out``; returns the float64 gauges dict."""
    f = _tables([problem], device, dtype)
    X, overs = _ladder(f, betas, _to_device([gauges], f), Dmax=Dmax,
                       tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
                       max_scale=max_scale, omega=omega)
    if overlaps_out is not None:
        o = overlaps_ud(_host64(overs[0]))
        overlaps_out.extend(o[2 * r:2 * r + 2] for r in range(len(betas)))
    return _to_host(X)[0]


def balance_ud_device(problem, beta, gauges, Dmax=8,
                      graduate_truncation=False, tolS=1e-16, tolV=1e-10,
                      max_sweeps=20, max_scale=1024, overlaps_out=None, *,
                      device=None, dtype=None, omega=None):
    """One rung of :func:`precondition_ladder_device`: the device
    counterpart of :func:`balance_ud`."""
    return precondition_ladder_device(
        problem, [beta], gauges, Dmax=Dmax, tolS=tolS, tolV=tolV,
        max_sweeps=max_sweeps, max_scale=max_scale,
        overlaps_out=overlaps_out, dtype=dtype, device=device, omega=omega)


def precondition_fleet(problems, betas, gauges_list=None, Dmax=8,
                       graduate_truncation=False, tolS=1e-16, tolV=1e-10,
                       max_sweeps=20, max_scale=1024, dtype=None, *,
                       device=None, omega=None):
    """The 'ud' beta ladder of same-shape problems (ValueError otherwise)
    in one B-batched device program (tnax's ``precondition_fleet``); each
    instance's gauges are those of its own
    :func:`precondition_ladder_device`. ``gauges_list`` defaults to the
    identity. Returns a list of float64 gauge dicts."""
    f = _tables(problems, device, dtype)
    X0 = f["X0"] if gauges_list is None else _to_device(gauges_list, f)
    X, _ = _ladder(f, betas, X0, Dmax=Dmax, tolS=tolS, tolV=tolV,
                   max_sweeps=max_sweeps, max_scale=max_scale, omega=omega)
    return _to_host(X)
