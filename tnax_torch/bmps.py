"""Boundary-MPS engine on torch tensors (main-path subset of tnax.bmps).

An MPS is one stacked tensor ``A`` of shape ``(B, L, D, d, D)``, every
bond and physical dimension padded to a static maximum, plus a log2 scale
``lognorm`` of shape ``(B,)``. The leading axis ``B`` runs over
independent instances: tnax vmaps its absorption over fleet instances
and boundary lanes (tnax/engine.py:252-253); here the batch axis is
written out, and one instance is the case B = 1. Ragged bond dimensions
appear as exactly-zero channels, as in tnax. ``lax.scan`` over sites
becomes a Python loop. The variational ``while_loop`` becomes a host loop
that reads one flag per sweep; as under tnax's vmap, a lane whose stop
condition holds keeps its state while the others sweep on, so every lane
ends where its unbatched run would.

The zip-up's randomized sketch takes its Gaussian matrices as an argument
(``omega``), so that a caller can hand in the very matrices tnax draws
from its PRNG keys; by default they come from a seeded
``torch.Generator`` (:func:`sketch_omega`). All lanes share one sketch,
as they do under tnax's vmap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class MPS(NamedTuple):
    """Batched stacked boundary MPS: ``A[(B, n, Dl, d, Dr)]`` and the log2
    norm factor ``lognorm[(B,)]`` of each instance."""
    A: torch.Tensor
    lognorm: torch.Tensor


def trivial_mps(B: int, L: int, D: int, d: int, dtype, device) -> MPS:
    """B product states of ones on the valid (index-0) channels."""
    A = torch.zeros((B, L, D, d, D), dtype=dtype, device=device)
    A[:, :, 0, 0, 0] = 1.0
    return MPS(A=A, lognorm=torch.zeros((B,), dtype=dtype, device=device))


def _per(v, x):
    """A per-instance vector v (B,) shaped to broadcast against x (B, ...)."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


# ---------------------------------------------------------------------------
# dense kernels
# ---------------------------------------------------------------------------

def nfactor(x: torch.Tensor) -> torch.Tensor:
    """Per instance (leading dim): the largest |entry| floored to a power
    of two; 1 for the zero tensor. Returns (B,)."""
    m = x.abs().reshape(x.shape[0], -1).amax(dim=1)
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
    """SVD with tnax's deterministic column-sign convention (batched over
    leading dims)."""
    U, S, Vh = torch.linalg.svd(M, full_matrices=False)
    flip = (U.amin(-2).abs() > U.amax(-2)) & (Vh.amin(-1).abs() > Vh.amax(-1))
    s = torch.where(flip, -1.0, 1.0).to(M.dtype)
    return U * s[..., None, :], S, Vh * s[..., :, None]


def _keep_mask(S, cap, tol):
    """Channels kept by a truncation: singular values above ``tol`` times
    the instance's largest, and at most ``cap`` of them. S (B, K)."""
    k = torch.arange(S.shape[-1], device=S.device)
    return (S > S[:, :1] * tol) & (k < cap)


def _top_or_one(S):
    """Each instance's largest singular value, 1 where it is 0."""
    s0 = S[:, 0]
    return torch.where(s0 > 0, s0, torch.ones_like(s0))


def truncate_center(C: torch.Tensor, cap: int, tol: float):
    """SVD-truncate each centre matrix C (B, n, n) to rank <= cap, dropping
    singular values below ``tol * S[0]``. Discarded channels are zeroed,
    not removed. Returns (U, S, Vh, discarded (B,))."""
    tol = max(torch.finfo(C.dtype).eps, tol)
    U, S, Vh = svd_fixed(C)
    keep = _keep_mask(S, cap, tol)
    discarded = torch.sqrt(torch.sum(torch.where(keep, 0.0, S) ** 2,
                                     dim=1)) / _top_or_one(S)
    S = torch.where(keep, S, 0.0)
    U = U * keep[:, None, :].to(C.dtype)
    Vh = Vh * keep[:, :, None].to(C.dtype)
    return U, S, Vh, discarded


def _absorb_final_scalar(C, lognorm):
    """Fold each final (1x1-valid) centre matrix C (B, ., .) into lognorm;
    returns (sign (B,) for the last-touched site tensor, lognorm)."""
    c = C[:, 0, 0]
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
    Returns (MPS, max_discarded (B,))."""
    B, L, Dl, d, Dr = mps.A.shape
    dtype, device = mps.A.dtype, mps.A.device
    C = torch.zeros((B, Dr, Dr), dtype=dtype, device=device)
    C[:, 0, 0] = 1.0
    lognorm = mps.lognorm
    disc = torch.zeros((B,), dtype=dtype, device=device)
    out = [None] * L
    for n in range(L - 1, -1, -1):
        Ai = torch.einsum("zadb,zbc->zadc", mps.A[:, n], C)
        Q, R = qr_fixed(Ai.reshape(B, Dl, d * Dr).transpose(1, 2))
        nf = nfactor(R)
        R = R / nf[:, None, None]
        lognorm = lognorm + torch.log2(nf)
        Qr = Q.transpose(1, 2).reshape(B, Dl, d, Dr)
        Craw = R.transpose(1, 2)  # sits on the left of site n
        if compress:
            U, S, Vh, dsc = truncate_center(Craw, cap, tol)
            out[n] = torch.einsum("zkb,zbdc->zkdc", Vh, Qr)
            C = U * S[:, None, :]
            disc = torch.maximum(disc, dsc)
        else:
            out[n], C = Qr, Craw
    sign, lognorm = _absorb_final_scalar(C, lognorm)
    out[0] = out[0] * sign[:, None, None, None]
    return MPS(A=torch.stack(out, dim=1), lognorm=lognorm), disc


def slice_bond(mps: MPS, D: int) -> MPS:
    """Shrink the padded bond dimension to D (exact once every bond has
    been truncated to rank <= D)."""
    return MPS(A=mps.A[:, :, :D, :, :D], lognorm=mps.lognorm)


# ---------------------------------------------------------------------------
# zip-up MPO application and variational polish
# ---------------------------------------------------------------------------

def _orient_mpo(W, conj):
    """W with legs (l, contract_phys, r, out_phys); W stacked
    (B, L, l, d, r, u). conj=True contracts the MPS leg with W's down
    leg."""
    return W if conj else W.permute(0, 1, 2, 5, 4, 3)


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
    iterations) of each Gm (B, m, n) with the shared Gaussian sketch
    ``Om`` (n, k). Returns (U (B, m, k), S (B, k), Vh (B, k, n))."""
    Gt = Gm.transpose(1, 2)
    Q, _ = torch.linalg.qr(Gm @ Om)
    for _ in range(iters):
        Z, _ = torch.linalg.qr(Gt @ Q)
        Q, _ = torch.linalg.qr(Gm @ Z)
    Ub, S, Vh = svd_fixed(Q.transpose(1, 2) @ Gm)
    return Q @ Ub, S, Vh


def check_rsvd(rsvd):
    """The zip-up's truncation choice as a bool: None (tnax's ambient
    default) and True are the randomized sketch, False the exact SVD.
    tnax's other sketches ("bf16", "wide") are not ported: ValueError for
    them and for any other value."""
    if rsvd is None:
        return True
    if isinstance(rsvd, bool):
        return rsvd
    raise ValueError(f"zipup_rsvd must be True, False or None, got {rsvd!r} "
                     f"(the 'bf16' and 'wide' sketches are not ported)")


def zipup_apply(mps: MPS, W: torch.Tensor, Dmax: int, *, conj: bool,
                tol: float, rsvd: bool = True, omega=None):
    """Left-to-right zip-up of W (B, L, l, d, r, u) onto mps, truncated to
    bond Dmax.

    ``mps`` should enter right-canonical. Returns (MPS(bond=Dmax),
    max_discarded (B,)); the result is left-canonical. Each instance keeps
    its own channels. The per-site truncation uses the randomized sketch
    when ``rsvd`` is set and the exact SVD core is at least twice the
    sketch rank, else the exact SVD (tnax's rule). ``omega`` is the
    sketch, shared by all instances: a tensor (L, n, k), a callable
    ``(L, n, k) -> tensor``, or None for :func:`sketch_omega`.
    """
    Wc = _orient_mpo(W, conj)
    B, L, D, d, _ = mps.A.shape
    lh, du = Wc.shape[2], Wc.shape[5]
    dtype, device = mps.A.dtype, mps.A.device
    tol = max(torch.finfo(dtype).eps, tol)
    rows, cols = Dmax * du, D * lh
    k_sketch = min(min(rows, cols), Dmax + 32)
    use_rsvd = check_rsvd(rsvd) and min(rows, cols) >= 2 * k_sketch
    if use_rsvd:
        if omega is None:
            omega = sketch_omega(L, cols, k_sketch, dtype, device)
        elif callable(omega):
            omega = omega(L, cols, k_sketch)
        if tuple(omega.shape) != (L, cols, k_sketch):
            raise ValueError(f"sketch shape {tuple(omega.shape)} != "
                             f"{(L, cols, k_sketch)}")
        omega = omega.to(device=device, dtype=dtype)

    T = torch.zeros((B, Dmax, D, lh), dtype=dtype, device=device)
    T[:, 0, 0, 0] = 1.0
    lognorm = mps.lognorm
    disc = torch.zeros((B,), dtype=dtype, device=device)
    out = []
    for n in range(L):
        t1 = torch.einsum("zmal,zadb->zmldb", T, mps.A[:, n])
        G = torch.einsum("zmldb,zldru->zmubr", t1, Wc[:, n])
        Gm = G.reshape(B, Dmax * du, D * lh)
        if use_rsvd:
            U, S, Vh = _rsvd(Gm, omega[n])
            S = torch.clamp(S, min=0.0)
            # exact total discarded mass, including what the sketch
            # never captured
            frob2 = torch.sum(Gm * Gm, dim=(1, 2))
        else:
            U, S, Vh = svd_fixed(Gm)
            frob2 = torch.sum(S * S, dim=1)
        K = S.shape[1]
        keep = _keep_mask(S, Dmax, tol)
        kept2 = torch.sum(torch.where(keep, S * S, 0.0), dim=1)
        disc = torch.maximum(
            disc, torch.sqrt(torch.clamp(frob2 - kept2, min=0.0))
            / _top_or_one(S))
        S = torch.where(keep, S, 0.0)
        U = (U * keep[:, None, :].to(dtype))[:, :, :Dmax]
        SV = (S[:, :, None] * Vh)[:, :Dmax]
        if K < Dmax:
            # thin rows: pad with exact zero channels
            U = torch.nn.functional.pad(U, (0, Dmax - K))
            SV = torch.nn.functional.pad(SV, (0, 0, 0, Dmax - K))
        out.append(U.reshape(B, Dmax, du, Dmax))
        Tn = SV.reshape(B, Dmax, D, lh)
        nf = nfactor(Tn)
        T = Tn / nf[:, None, None, None]
        lognorm = lognorm + torch.log2(nf)
    sign, lognorm = _absorb_final_scalar(T[..., 0], lognorm)
    out[L - 1] = out[L - 1] * sign[:, None, None, None]
    return MPS(A=torch.stack(out, dim=1), lognorm=lognorm), disc


def variational_implicit(mps: MPS, phi_A: torch.Tensor, W: torch.Tensor, *,
                         conj: bool, tol: float, max_sweeps: int):
    """Variational compression against the implicit target phi∘W.

    Alternating one-site sweeps with three-leg mixed environments (new
    bond, old bond, MPO bond), so the fat MPS never exists. ``mps.A``
    enters left-canonical (zip-up output). Each instance stops on its own
    rule (tnax's ``while_loop`` condition): a lane that has stopped keeps
    its tensors, Schmidt values, environments, overlap and norm while the
    others sweep on, and the loop ends when no lane is active. Returns
    (MPS, overlap (B,), sweeps (B,) int64).
    """
    Wc = _orient_mpo(W, conj)
    A0 = mps.A
    B, L, Dn, du, _ = A0.shape
    Do, lh = phi_A.shape[2], Wc.shape[2]
    dtype, device = A0.dtype, A0.device
    tiny = torch.finfo(dtype).tiny
    zero = torch.zeros((B,), dtype=dtype, device=device)

    fl0 = torch.zeros((B, Dn, Do, lh), dtype=dtype, device=device)
    fl0[:, 0, 0, 0] = 1.0
    fr0 = torch.zeros((B, Do, lh, Dn), dtype=dtype, device=device)
    fr0[:, 0, 0, 0] = 1.0

    def half_project(F, p, Wn):
        t1 = torch.einsum("zmal,zadb->zmldb", F, p)
        return torch.einsum("zmldb,zldru->zmbur", t1, Wn)   # (m, b, u, r)

    def upd_left(F, p, Wn, a):
        return torch.einsum("zmbur,zmuk->zkbr", half_project(F, p, Wn), a)

    def upd_right(G, p, Wn, a):
        t1 = torch.einsum("zadb,zbrk->zadrk", p, G)
        t2 = torch.einsum("zadrk,zldru->zaluk", t1, Wn)
        return torch.einsum("zaluk,zmuk->zalm", t2, a)

    def project(F, p, Wn, G):
        return torch.einsum("zmbur,zbrk->zmuk", half_project(F, p, Wn), G)

    def rescale(F, ln):
        # power-of-2 rescaling of the environment chain; the target is
        # unnormalized, so its log2 scale accumulates in ``ln``
        nf = nfactor(F)
        return F / _per(nf, F), ln + torch.log2(nf)

    FLs = [fl0]
    F, ln0 = fl0, zero
    for n in range(L):
        F, ln0 = rescale(upd_left(F, phi_A[:, n], Wc[:, n], A0[:, n]), ln0)
        FLs.append(F)
    overlap = FLs[L][:, 0, 0, 0] * torch.exp2(ln0)
    S0 = torch.zeros((B, L + 1, Dn), dtype=dtype, device=device)
    S0[:, :, 0] = 1.0

    def right_sweep(A, S, FLs):
        A, S = list(A), list(S)
        FR = fr0
        FRs = [None] * L
        FRs[L - 1] = fr0
        for n in range(L - 1, 0, -1):
            Bn = project(FLs[n], phi_A[:, n], Wc[:, n], FR)
            Q, R = qr_fixed(Bn.reshape(B, Dn, du * Dn).transpose(1, 2))
            A[n] = Q.transpose(1, 2).reshape(B, Dn, du, Dn)
            sv = torch.linalg.svdvals(R.transpose(1, 2))
            S[n] = sv / torch.clamp(sv[:, :1], min=tiny)
            FR, _ = rescale(upd_right(FR, phi_A[:, n], Wc[:, n], A[n]), zero)
            FRs[n - 1] = FR
        return A, S, FRs

    def left_sweep(A, S, FRs):
        A, S = list(A), list(S)
        FL, ln, diff, lnstate = fl0, zero, zero, zero
        FLs = [fl0]
        for n in range(L):
            Bn = project(FL, phi_A[:, n], Wc[:, n], FRs[n])
            Q, R = qr_fixed(Bn.reshape(B, Dn * du, Dn))
            A[n] = Q.reshape(B, Dn, du, Dn)
            sv = torch.linalg.svdvals(R)
            sv = sv / torch.clamp(sv[:, :1], min=tiny)
            diff = torch.maximum(diff, torch.sqrt(torch.sum(
                (S[n + 1] - sv) ** 2, dim=1)))
            S[n + 1] = sv
            # at the last site the right env is trivial, so |R[0,0]|*2^ln
            # is the norm of the projected state
            lnstate = ln + torch.log2(torch.clamp(R[:, 0, 0].abs(),
                                                  min=tiny))
            FL, ln = rescale(upd_left(FL, phi_A[:, n], Wc[:, n], A[n]), ln)
            FLs.append(FL)
        return A, S, FLs, diff, FL[:, 0, 0, 0] * torch.exp2(ln), lnstate

    # f32 plateau stop: from the second sweep on, stop when a sweep no
    # longer shrinks the Schmidt-vector change by 10%
    plateau = torch.finfo(dtype).eps > 1e-10

    def going(diff, prev, sweeps):
        g = (diff > tol) & (sweeps < max_sweeps)
        if plateau:
            g = g & ((sweeps < 2) | (diff < prev * 0.9))
        return g

    def keep_old(active, new, old):
        return [torch.where(_per(active, a), a, b) for a, b in zip(new, old)]

    A, S = list(A0.unbind(1)), list(S0.unbind(1))
    diff = torch.ones((B,), dtype=dtype, device=device)
    prev = torch.full((B,), float("inf"), dtype=dtype, device=device)
    sweeps = torch.zeros((B,), dtype=torch.int64, device=device)
    ln_state = zero
    active = going(diff, prev, sweeps)
    while bool(active.any()):        # one host read per sweep
        A1, S1, FRs = right_sweep(A, S, FLs)
        A1, S1, FLs1, diff1, ov1, ln1 = left_sweep(A1, S1, FRs)
        A = keep_old(active, A1, A)
        S = keep_old(active, S1, S)
        FLs = keep_old(active, FLs1, FLs)
        prev = torch.where(active, diff, prev)
        diff = torch.where(active, diff1, diff)
        overlap = torch.where(active, ov1, overlap)
        ln_state = torch.where(active, ln1, ln_state)
        sweeps = sweeps + active.long()
        active = going(diff, prev, sweeps)
    return (MPS(A=torch.stack(A, dim=1), lognorm=mps.lognorm + ln_state),
            overlap, sweeps)


def compress_apply(mps: MPS, W: torch.Tensor, Dmax: int, *, conj: bool,
                   tolS: float, tolV: float, max_sweeps: int,
                   rsvd: bool = True, omega=None):
    """Apply one MPO row W (B, L, l, d, r, u) to an MPS and compress to
    Dmax, fat-MPS-free: right-canonize, zip-up at bond 2*Dmax, one
    truncation sweep down to Dmax, then variational polish. Returns
    (MPS, overlap (B,), discarded (B,), sweeps (B,))."""
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
    out, overlap, sweeps = variational_implicit(
        out, mps.A, W, conj=conj, tol=tolV, max_sweeps=max_sweeps)
    return out, overlap, disc, sweeps
