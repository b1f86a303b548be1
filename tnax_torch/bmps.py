"""Boundary-MPS engine on torch tensors (main-path subset of tnax.bmps).

An MPS is one stacked tensor ``A`` of shape ``(L, D, d, D)``, every bond
and physical dimension padded to a static maximum, plus a scalar
``lognorm`` (accumulated log2 scale). Ragged bond dimensions appear as
exactly-zero channels, as in tnax. ``lax.scan`` over sites becomes a
Python loop; the variational plateau ``while_loop`` becomes a host loop
that reads one scalar per sweep.

The zip-up's randomized sketch takes its Gaussian matrices as an argument
(``omega``), so that a caller can hand in the very matrices tnax draws
from its PRNG keys; by default they come from a seeded
``torch.Generator`` (:func:`sketch_omega`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class MPS(NamedTuple):
    """Stacked boundary MPS: ``A[(n, Dl, d, Dr)]`` + log2 norm factor."""
    A: torch.Tensor
    lognorm: torch.Tensor


def trivial_mps(L: int, D: int, d: int, dtype, device) -> MPS:
    """Product state of ones on the valid (index-0) channels."""
    A = torch.zeros((L, D, d, D), dtype=dtype, device=device)
    A[:, 0, 0, 0] = 1.0
    return MPS(A=A, lognorm=torch.zeros((), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# dense kernels
# ---------------------------------------------------------------------------

def nfactor(x: torch.Tensor) -> torch.Tensor:
    """Largest |entry| floored to a power of two; 1 for the zero matrix."""
    m = x.abs().amax()
    m = torch.where(m > 0, m, torch.ones_like(m))
    return torch.exp2(torch.floor(torch.log2(m)))


def qr_fixed(M: torch.Tensor):
    """Economic QR with the sign of diag(R) fixed to be non-negative
    (batched over leading dims)."""
    Q, R = torch.linalg.qr(M, mode="reduced")
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s[..., None, :], R * s[..., :, None]


def svd_fixed(M: torch.Tensor):
    """SVD with tnax's deterministic column-sign convention."""
    U, S, Vh = torch.linalg.svd(M, full_matrices=False)
    flip = (U.amin(-2).abs() > U.amax(-2)) & (Vh.amin(-1).abs() > Vh.amax(-1))
    s = torch.where(flip, -1.0, 1.0).to(M.dtype)
    return U * s[..., None, :], S, Vh * s[..., :, None]


def truncate_center(C: torch.Tensor, cap: int, tol: float):
    """SVD-truncate the centre matrix to rank <= cap, dropping singular
    values below ``tol * S[0]``. Discarded channels are zeroed, not
    removed. Returns (U, S, Vh, discarded)."""
    tol = max(torch.finfo(C.dtype).eps, tol)
    U, S, Vh = svd_fixed(C)
    k = torch.arange(S.shape[0], device=C.device)
    keep = (S > S[0] * tol) & (k < cap)
    s0 = torch.where(S[0] > 0, S[0], torch.ones_like(S[0]))
    discarded = torch.sqrt(torch.sum(torch.where(keep, 0.0, S) ** 2)) / s0
    S = torch.where(keep, S, 0.0)
    U = U * keep[None, :].to(C.dtype)
    Vh = Vh * keep[:, None].to(C.dtype)
    return U, S, Vh, discarded


def _absorb_final_scalar(C, lognorm):
    """Fold the final (1x1-valid) centre matrix into lognorm; returns
    (sign for the last-touched site tensor, lognorm)."""
    c = C[0, 0]
    mag = c.abs()
    one = torch.ones_like(mag)
    lognorm = lognorm + torch.where(mag > 0, torch.log2(torch.where(
        mag > 0, mag, one)), 0.0)
    sign = torch.where(c < 0, -1.0, 1.0).to(C.dtype)
    return sign, lognorm


# ---------------------------------------------------------------------------
# canonization
# ---------------------------------------------------------------------------

def canonize_right(mps: MPS, *, compress: bool = False, cap: int = None,
                   tol: float = 0.0):
    """Right-canonize; optionally SVD-truncate every bond to <= cap.
    Returns (MPS, max_discarded)."""
    L, Dl, d, Dr = mps.A.shape
    dtype, device = mps.A.dtype, mps.A.device
    C = torch.zeros((Dr, Dr), dtype=dtype, device=device)
    C[0, 0] = 1.0
    lognorm = mps.lognorm
    disc = torch.zeros((), dtype=dtype, device=device)
    out = [None] * L
    for n in range(L - 1, -1, -1):
        Ai = torch.einsum("adb,bc->adc", mps.A[n], C)
        Q, R = qr_fixed(Ai.reshape(Dl, d * Dr).T)
        nf = nfactor(R)
        R = R / nf
        lognorm = lognorm + torch.log2(nf)
        Qr = Q.T.reshape(Dl, d, Dr)
        Craw = R.T  # sits on the left of site n
        if compress:
            U, S, Vh, dsc = truncate_center(Craw, cap, tol)
            out[n] = torch.einsum("kb,bdc->kdc", Vh, Qr)
            C = U * S[None, :]
            disc = torch.maximum(disc, dsc)
        else:
            out[n], C = Qr, Craw
    sign, lognorm = _absorb_final_scalar(C, lognorm)
    out[0] = out[0] * sign
    return MPS(A=torch.stack(out), lognorm=lognorm), disc


def slice_bond(mps: MPS, D: int) -> MPS:
    """Shrink the padded bond dimension to D (exact once every bond has
    been truncated to rank <= D)."""
    return MPS(A=mps.A[:, :D, :, :D], lognorm=mps.lognorm)


# ---------------------------------------------------------------------------
# zip-up MPO application and variational polish
# ---------------------------------------------------------------------------

def _orient_mpo(W, conj):
    """W with legs (l, contract_phys, r, out_phys); W stacked
    (L, l, d, r, u). conj=True contracts the MPS leg with W's down leg."""
    return W if conj else W.permute(0, 1, 4, 3, 2)


@functools.lru_cache(maxsize=8)
def sketch_omega(L: int, n: int, k: int, dtype, device, seed: int = 0):
    """Default Gaussian sketch matrices (L, n, k) of the zip-up.

    Drawn in float64 on the CPU from a seeded generator and then moved,
    so a CPU run and a CUDA run (and both dtypes) use the same numbers.
    Read-only: every caller with the same arguments shares the tensor."""
    g = torch.Generator().manual_seed(seed)
    om = torch.randn((L, n, k), generator=g, dtype=torch.float64)
    return om.to(device=device, dtype=dtype)


def _rsvd(Gm: torch.Tensor, Om: torch.Tensor, iters: int = 2):
    """Randomized top-k SVD (Halko-Martinsson-Tropp with power
    iterations) with the Gaussian sketch ``Om`` (n, k) given. Returns
    (U (m, k), S (k,), Vh (k, n))."""
    Q, _ = torch.linalg.qr(Gm @ Om)
    for _ in range(iters):
        Z, _ = torch.linalg.qr(Gm.T @ Q)
        Q, _ = torch.linalg.qr(Gm @ Z)
    B = Q.T @ Gm
    Ub, S, Vh = svd_fixed(B)
    return Q @ Ub, S, Vh


def zipup_apply(mps: MPS, W: torch.Tensor, Dmax: int, *, conj: bool,
                tol: float, rsvd: bool = True, omega=None):
    """Left-to-right zip-up of W onto mps, truncated to bond Dmax.

    ``mps`` should enter right-canonical. Returns (MPS(bond=Dmax),
    max_discarded); the result is left-canonical. The per-site truncation
    uses the randomized sketch when ``rsvd`` is set and the exact SVD core
    is at least twice the sketch rank, else the exact SVD (tnax's rule).
    ``omega`` is the sketch: a tensor (L, n, k), a callable
    ``(L, n, k) -> tensor``, or None for :func:`sketch_omega`.
    """
    Wc = _orient_mpo(W, conj)
    L, D, d, _ = mps.A.shape
    lh, du = Wc.shape[1], Wc.shape[4]
    dtype, device = mps.A.dtype, mps.A.device
    tol = max(torch.finfo(dtype).eps, tol)
    rows, cols = Dmax * du, D * lh
    k_sketch = min(min(rows, cols), Dmax + 32)
    use_rsvd = bool(rsvd) and min(rows, cols) >= 2 * k_sketch
    if use_rsvd:
        if omega is None:
            omega = sketch_omega(L, cols, k_sketch, dtype, device)
        elif callable(omega):
            omega = omega(L, cols, k_sketch)
        if tuple(omega.shape) != (L, cols, k_sketch):
            raise ValueError(f"sketch shape {tuple(omega.shape)} != "
                             f"{(L, cols, k_sketch)}")
        omega = omega.to(device=device, dtype=dtype)

    T = torch.zeros((Dmax, D, lh), dtype=dtype, device=device)
    T[0, 0, 0] = 1.0
    lognorm = mps.lognorm
    disc = torch.zeros((), dtype=dtype, device=device)
    out = []
    for n in range(L):
        t1 = torch.einsum("mal,adb->mldb", T, mps.A[n])
        G = torch.einsum("mldb,ldru->mubr", t1, Wc[n])
        Gm = G.reshape(Dmax * du, D * lh)
        if use_rsvd:
            U, S, Vh = _rsvd(Gm, omega[n])
            S = torch.clamp(S, min=0.0)
            # exact total discarded mass, including what the sketch
            # never captured
            frob2 = torch.sum(Gm * Gm)
        else:
            U, S, Vh = svd_fixed(Gm)
            frob2 = torch.sum(S * S)
        K = S.shape[0]
        keep = (S > S[0] * tol) & (torch.arange(K, device=device) < Dmax)
        s0 = torch.where(S[0] > 0, S[0], torch.ones_like(S[0]))
        kept2 = torch.sum(torch.where(keep, S * S, 0.0))
        disc = torch.maximum(
            disc, torch.sqrt(torch.clamp(frob2 - kept2, min=0.0)) / s0)
        S = torch.where(keep, S, 0.0)
        U = (U * keep[None, :].to(dtype))[:, :Dmax]
        SV = (S[:, None] * Vh)[:Dmax]
        if K < Dmax:
            # thin rows: pad with exact zero channels
            U = torch.nn.functional.pad(U, (0, Dmax - K))
            SV = torch.nn.functional.pad(SV, (0, 0, 0, Dmax - K))
        out.append(U.reshape(Dmax, du, Dmax))
        Tn = SV.reshape(Dmax, D, lh)
        nf = nfactor(Tn)
        T = Tn / nf
        lognorm = lognorm + torch.log2(nf)
    sign, lognorm = _absorb_final_scalar(T[:, :, 0], lognorm)
    out[L - 1] = out[L - 1] * sign
    return MPS(A=torch.stack(out), lognorm=lognorm), disc


def variational_implicit(mps: MPS, phi_A: torch.Tensor, W: torch.Tensor, *,
                         conj: bool, tol: float, max_sweeps: int):
    """Variational compression against the implicit target phi∘W.

    Alternating one-site sweeps with three-leg mixed environments (new
    bond, old bond, MPO bond), so the fat MPS never exists. ``mps.A``
    enters left-canonical (zip-up output). Returns (MPS, overlap).
    """
    Wc = _orient_mpo(W, conj)
    A0 = mps.A
    L, Dn, du, _ = A0.shape
    Do, lh = phi_A.shape[1], Wc.shape[1]
    dtype, device = A0.dtype, A0.device
    tiny = torch.finfo(dtype).tiny
    zero = torch.zeros((), dtype=dtype, device=device)

    fl0 = torch.zeros((Dn, Do, lh), dtype=dtype, device=device)
    fl0[0, 0, 0] = 1.0
    fr0 = torch.zeros((Do, lh, Dn), dtype=dtype, device=device)
    fr0[0, 0, 0] = 1.0

    def half_project(F, p, Wn):
        t1 = torch.einsum("mal,adb->mldb", F, p)
        return torch.einsum("mldb,ldru->mbur", t1, Wn)   # (m, b, u, r)

    def upd_left(F, p, Wn, a):
        return torch.einsum("mbur,muk->kbr", half_project(F, p, Wn), a)

    def upd_right(G, p, Wn, a):
        t1 = torch.einsum("adb,brk->adrk", p, G)
        t2 = torch.einsum("adrk,ldru->aluk", t1, Wn)
        return torch.einsum("aluk,muk->alm", t2, a)

    def project(F, p, Wn, G):
        return torch.einsum("mbur,brk->muk", half_project(F, p, Wn), G)

    def rescale(F, ln):
        # power-of-2 rescaling of the environment chain; the target is
        # unnormalized, so its log2 scale accumulates in ``ln``
        nf = nfactor(F)
        return F / nf, ln + torch.log2(nf)

    FLs = [fl0]
    F, ln0 = fl0, zero
    for n in range(L):
        F, ln0 = rescale(upd_left(F, phi_A[n], Wc[n], A0[n]), ln0)
        FLs.append(F)
    overlap = FLs[L][0, 0, 0] * torch.exp2(ln0)
    S = torch.zeros((L + 1, Dn), dtype=dtype, device=device)
    S[:, 0] = 1.0
    S = list(S)
    A = list(A0)

    def right_sweep(FLs):
        FR = fr0
        FRs = [None] * L
        FRs[L - 1] = fr0
        for n in range(L - 1, 0, -1):
            B = project(FLs[n], phi_A[n], Wc[n], FR)
            Q, R = qr_fixed(B.reshape(Dn, du * Dn).T)
            A[n] = Q.T.reshape(Dn, du, Dn)
            sv = torch.linalg.svdvals(R.T)
            S[n] = sv / torch.clamp(sv[0], min=tiny)
            FR, _ = rescale(upd_right(FR, phi_A[n], Wc[n], A[n]), zero)
            FRs[n - 1] = FR
        return FRs

    def left_sweep(FRs):
        FL, ln, diff, lnstate = fl0, zero, zero, zero
        FLs = [fl0]
        for n in range(L):
            B = project(FL, phi_A[n], Wc[n], FRs[n])
            Q, R = qr_fixed(B.reshape(Dn * du, Dn))
            A[n] = Q.reshape(Dn, du, Dn)
            sv = torch.linalg.svdvals(R)
            sv = sv / torch.clamp(sv[0], min=tiny)
            diff = torch.maximum(diff, torch.sqrt(torch.sum(
                (S[n + 1] - sv) ** 2)))
            S[n + 1] = sv
            # at the last site the right env is trivial, so |R[0,0]|*2^ln
            # is the norm of the projected state
            lnstate = ln + torch.log2(torch.clamp(R[0, 0].abs(), min=tiny))
            FL, ln = rescale(upd_left(FL, phi_A[n], Wc[n], A[n]), ln)
            FLs.append(FL)
        return FLs, diff, FL[0, 0, 0] * torch.exp2(ln), lnstate

    # f32 plateau stop: from the second sweep on, stop when a sweep no
    # longer shrinks the Schmidt-vector change by 10%
    plateau = torch.finfo(dtype).eps > 1e-10
    diff, prev = 1.0, float("inf")
    ln_state = zero
    sweeps = 0
    while diff > tol and sweeps < max_sweeps and (
            not plateau or sweeps < 2 or diff < prev * 0.9):
        FRs = right_sweep(FLs)
        FLs, diff_t, overlap, ln_state = left_sweep(FRs)
        prev, diff = diff, diff_t.item()   # one host read per sweep
        sweeps += 1
    return MPS(A=torch.stack(A), lognorm=mps.lognorm + ln_state), overlap


def compress_apply(mps: MPS, W: torch.Tensor, Dmax: int, *, conj: bool,
                   tolS: float, tolV: float, max_sweeps: int,
                   rsvd: bool = True, omega=None):
    """Apply one MPO row to an MPS and compress to Dmax, fat-MPS-free:
    right-canonize, zip-up at bond 2*Dmax, one truncation sweep down to
    Dmax, then variational polish. Returns (MPS, overlap, discarded)."""
    eps = torch.finfo(mps.A.dtype).eps
    tolS = max(tolS, eps)
    tolV = max(tolV, 32 * eps)
    mps, _ = canonize_right(mps)
    out, disc = zipup_apply(mps, W, 2 * Dmax, conj=conj, tol=tolS / 10,
                            rsvd=rsvd, omega=omega)
    out, disc2 = canonize_right(out, compress=True, cap=Dmax, tol=tolS)
    disc = torch.maximum(disc, disc2)
    out = slice_bond(out, Dmax)
    # the polish reconstructs the state norm from scratch, so it starts
    # from the target's lognorm, not the zip-up's
    out = out._replace(lognorm=mps.lognorm)
    out, overlap = variational_implicit(out, mps.A, W, conj=conj, tol=tolV,
                                        max_sweeps=max_sweeps)
    return out, overlap, disc
