"""Boundary-MPS engine on torch tensors (tnax.bmps).

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
ends where its unbatched run would. At the balancing ladder's shapes a
row's zip-up and truncation sweep run instead in one launch of kernel K6
(``kernels.zipup``) and its polish in one launch of K5
(``kernels.polish``), each lane to its own stop on the card. Elsewhere
every SVD on the card in float32 (:func:`svd_fixed`, :func:`svdvals`: the
zip-up's core, the truncation sweep, the polish's singular values) is one
launch of K7 (``kernels.svd``) where its shape fits, so that a row reads
the device only at the polish's stop.

Two row absorptions: the zip-up (:func:`compress_apply`, the default of
the boundary stacks) and the reference's fat path (:func:`apply_mpo`
then :func:`compress`, graduate truncation and :func:`variational_compress`).
The zip-up's randomized sketch takes its Gaussian matrices as an argument
(``omega``), so that a caller can hand in the very matrices tnax draws
from its PRNG keys; by default they come from a seeded
``torch.Generator`` (:func:`sketch_omega`). All lanes share one sketch,
as they do under tnax's vmap.

The MPS API of tnax's users (:func:`init_mps`, :func:`identity_mpo`,
:func:`mpo_from_block`, the expectation values and measurements,
:func:`mps_dot`, :func:`describe`) takes tnax's shapes, without the
instance axis, as well as batched ones; so do :func:`canonize_left` and
:func:`canonize_right`. :func:`init_mps` builds on CUDA unless given
``device``. Complex MPS (``init_mps(initial="randC")``) canonize and
contract; nothing is conjugated that tnax does not conjugate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import config
from .kernels import polish as _polish
from .kernels import svd as _svd
from .kernels import zipup as _zipup


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


def _lift_mps(mps: MPS):
    """(mps with the instance axis, whether it was added): tnax's
    unbatched MPS (A (L, D, d, D), scalar lognorm) is a batch of one."""
    if mps.A.dim() == 4:
        return MPS(A=mps.A[None], lognorm=mps.lognorm.reshape(1)), True
    return mps, False


def _unlift(x, single):
    return x[0] if single else x


def _e00(B, Dl, Dr, dtype, device):
    """B matrices (Dl, Dr) with a one at (0, 0): the trivial boundary."""
    e = torch.zeros((B, Dl, Dr), dtype=dtype, device=device)
    e[:, 0, 0] = 1.0
    return e


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
    (batched over leading dims). For complex M the phase of each diagonal
    entry moves into Q (Q s, conj(s) R), which is tnax's rule wherever the
    diagonal is real, as LAPACK's Householder QR makes it."""
    Q, R = torch.linalg.qr(M, mode="reduced")
    s = torch.sgn(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s[..., None, :], R * s.conj()[..., :, None]


def svd_fixed(M: torch.Tensor):
    """SVD with tnax's deterministic column-sign convention (batched over
    leading dims). Float32 CUDA matrices in K7's envelope
    (``kernels.svd.engages``) run K7, one launch and no host read;
    everything else :func:`svd_fixed_plain`."""
    if _svd.engages(M):
        return _svd_k7(M, vectors=True)
    return svd_fixed_plain(M)


def svd_fixed_plain(M: torch.Tensor):
    """:func:`svd_fixed` by ``torch.linalg.svd``, which on the card reads
    cuSOLVER's info on the host."""
    U, S, Vh = torch.linalg.svd(M, full_matrices=False)
    flip = (U.amin(-2).abs() > U.amax(-2)) & (Vh.amin(-1).abs() > Vh.amax(-1))
    s = torch.where(flip, -1.0, 1.0).to(M.dtype)
    return U * s[..., None, :], S, Vh * s[..., :, None]


def svdvals(M: torch.Tensor):
    """The singular values of each matrix (batched over leading dims),
    descending: K7 where :func:`svd_fixed` takes it, else
    ``torch.linalg.svdvals``."""
    if _svd.engages(M):
        return _svd_k7(M, vectors=False)
    return torch.linalg.svdvals(M)


def _svd_k7(M, vectors):
    """K7's SVD (or singular values) with the stage clock's counter: a
    recording clock counts the call (``svd_k7``); nothing waits either
    way."""
    out = _svd.svd_fixed(M) if vectors else _svd.svdvals(M)
    rec = config.recording()
    if rec is not None:
        rec.count("svd_k7", 1)
    return out


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
    returns (sign (B,) for the last-touched site tensor, lognorm). For
    complex C the sign is the phase c / |c|."""
    c = C[:, 0, 0]
    mag = c.abs()
    one = torch.ones_like(mag)
    lognorm = lognorm + torch.where(mag > 0, torch.log2(torch.where(
        mag > 0, mag, one)), 0.0)
    if C.is_complex():
        sign = torch.where(mag > 0, c / torch.where(mag > 0, mag, one),
                           torch.ones_like(c))
    else:
        sign = torch.where(c < 0, -1.0, 1.0).to(C.dtype)
    return sign, lognorm


# ---------------------------------------------------------------------------
# canonization
# ---------------------------------------------------------------------------

def canonize_left(mps: MPS, *, compress: bool = False, cap: int = None,
                  tol: float = 0.0):
    """Left-canonize; optionally SVD-truncate every bond to <= cap.
    Returns (MPS, max_discarded (B,)); an unbatched MPS gives an unbatched
    result and a scalar."""
    mps, single = _lift_mps(mps)
    B, L, Dl, d, Dr = mps.A.shape
    dtype, device = mps.A.dtype, mps.A.device
    C = _e00(B, Dl, Dl, dtype, device)
    lognorm = mps.lognorm
    disc = torch.zeros((B,), dtype=dtype.to_real(), device=device)
    out = []
    for n in range(L):
        Ai = torch.einsum("zab,zbdc->zadc", C, mps.A[:, n])
        Q, R = qr_fixed(Ai.reshape(B, Dl * d, Dr))
        nf = nfactor(R)
        R = R / nf[:, None, None]
        lognorm = lognorm + torch.log2(nf)
        Qr = Q.reshape(B, Dl, d, Dr)
        if compress:
            U, S, Vh, dsc = truncate_center(R, cap, tol)
            out.append(torch.einsum("zadb,zbk->zadk", Qr, U))
            C = S[:, :, None] * Vh
            disc = torch.maximum(disc, dsc)
        else:
            out.append(Qr)
            C = R
    sign, lognorm = _absorb_final_scalar(C, lognorm)
    out[L - 1] = out[L - 1] * sign[:, None, None, None]
    out = MPS(A=torch.stack(out, dim=1), lognorm=lognorm)
    return (MPS(*(_unlift(x, single) for x in out)), _unlift(disc, single))


def canonize_right(mps: MPS, *, compress: bool = False, cap: int = None,
                   tol: float = 0.0):
    """Right-canonize; optionally SVD-truncate every bond to <= cap.
    Returns (MPS, max_discarded (B,)); an unbatched MPS gives an unbatched
    result and a scalar."""
    mps, single = _lift_mps(mps)
    B, L, Dl, d, Dr = mps.A.shape
    dtype, device = mps.A.dtype, mps.A.device
    C = _e00(B, Dr, Dr, dtype, device)
    lognorm = mps.lognorm
    disc = torch.zeros((B,), dtype=dtype.to_real(), device=device)
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
    out = MPS(A=torch.stack(out, dim=1), lognorm=lognorm)
    return (MPS(*(_unlift(x, single) for x in out)), _unlift(disc, single))


def slice_bond(mps: MPS, D: int) -> MPS:
    """Shrink the padded bond dimension to D (exact once every bond has
    been truncated to rank <= D)."""
    return MPS(A=mps.A[:, :, :D, :, :D], lognorm=mps.lognorm)


def pad_bond(mps: MPS, D: int) -> MPS:
    """Pad the bond dimension to D with exact zero channels."""
    B, L, Dl, d, Dr = mps.A.shape
    if Dl == D:
        return mps
    A = mps.A.new_zeros((B, L, D, d, D))
    A[:, :, :Dl, :, :Dr] = mps.A
    return MPS(A=A, lognorm=mps.lognorm)


# ---------------------------------------------------------------------------
# MPO application and variational compression against a fat target
# ---------------------------------------------------------------------------

def apply_mpo(mps: MPS, W: torch.Tensor, *, conj: bool) -> MPS:
    """Apply one row of traced PEPS tensors W (B, L, l, d, r, u) to the
    MPS, giving the fat MPS of bond D*l. conj=True (top boundary): the
    MPS leg contracts W's down leg, leaving the up leg, and the fat bond is
    (mps, mpo) mps-major; conj=False is the mirror with an mpo-major fat
    bond, as in tnax."""
    B, L, D, d, _ = mps.A.shape
    lh = W.shape[2]
    if conj:
        fat = torch.einsum("znadb,znldru->znalubr", mps.A, W)
    else:
        fat = torch.einsum("znldru,znaub->znladrb", W, mps.A)
    return MPS(A=fat.reshape(B, L, D * lh, -1, D * lh), lognorm=mps.lognorm)


def _mix_left(RL, p, a):
    """RL'[c', f'] = sum RL[c, f] phi[f, d, f'] A[c, d, c'] per instance."""
    T = torch.einsum("zcf,zfdg->zcdg", RL, p)
    return torch.einsum("zcdg,zcdk->zkg", T, a)


def _mix_right(RR, p, a):
    """RR'[f', c'] = sum phi[f', d, f] RR[f, c] A[c', d, c] per instance."""
    T = torch.einsum("zfdg,zgc->zfdc", p, RR)
    return torch.einsum("zfdc,zkdc->zfk", T, a)


def _project(RL, p, RR):
    """B[c, d, c'] = RL[c, f] phi[f, d, f'] RR[f', c'] per instance."""
    T = torch.einsum("zcf,zfdg->zcdg", RL, p)
    return torch.einsum("zcdg,zgk->zcdk", T, RR)


def _alternate(A0, FLs, overlap, right_sweep, left_sweep, *, tol,
               max_sweeps):
    """The stop loop of the alternating one-site sweeps, shared by both
    variational compressions: from left-canonical A0 (B, L, Dn, d, Dn)
    with its left environments FLs and their overlap, each active lane
    runs a right sweep then a left sweep until its Schmidt-vector change
    is at most ``tol`` or it has run ``max_sweeps`` (tnax's
    ``while_loop`` condition, with the float32 plateau stop). A lane
    that has stopped keeps its tensors, Schmidt values, environments,
    overlap and norm while the others sweep on; one host read per sweep.
    A recording stage clock (``config.recording``) counts the passes, the
    reads' waits and the seconds from the first read's return to the
    last's (``variational_s``). Returns (A, overlap (B,), ln_state (B,),
    sweeps (B,) int64)."""
    B, L, Dn = A0.shape[:3]
    dtype, device = A0.dtype, A0.device
    S0 = torch.zeros((B, L + 1, Dn), dtype=dtype, device=device)
    S0[:, :, 0] = 1.0
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
    ln_state = torch.zeros((B,), dtype=dtype, device=device)
    rec = config.recording()

    def more(active):           # one host read per sweep
        if rec is None:
            return bool(active.any())
        return rec.read(bool, active.any())

    active = going(diff, prev, sweeps)
    go = more(active)
    start = rec.read_end if rec is not None else None
    passes = 0
    while go:
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
        passes += 1
        go = more(active)
    if rec is not None:
        rec.count("passes", passes)
        rec.count("variational_s", rec.read_end - start)
    return torch.stack(A, dim=1), overlap, ln_state, sweeps


def _rescale(F, ln):
    """Power-of-2 rescaling of an environment chain; the target is
    unnormalized, so its log2 scale accumulates in ``ln``."""
    nf = nfactor(F)
    return F / _per(nf, F), ln + torch.log2(nf)


def variational_compress(mps: MPS, phi: torch.Tensor, *, tol: float,
                         max_sweeps: int):
    """Alternating one-site compression of ``mps`` against the target
    phi (B, L, F, d, F), typically a right-canonical fat MPS.

    ``mps.A`` enters left-canonical, as :func:`canonize_left` makes it.
    Each instance stops on its own Schmidt-vector rule (see
    :func:`_alternate`). Returns (MPS, overlap (B,), sweeps (B,)), the
    overlap <phi|mps> without lognorm factors (a diagnostic, as in tnax).
    """
    A0 = mps.A
    B, L, D, d, _ = A0.shape
    F = phi.shape[2]
    dtype, device = A0.dtype, A0.device
    tiny = torch.finfo(dtype).tiny
    zero = torch.zeros((B,), dtype=dtype, device=device)
    rl0 = _e00(B, D, F, dtype, device)
    rr_triv = _e00(B, F, D, dtype, device)

    RLs = [rl0]
    rl, ln0 = rl0, zero
    for n in range(L):
        rl, ln0 = _rescale(_mix_left(rl, phi[:, n], A0[:, n]), ln0)
        RLs.append(rl)
    overlap = RLs[L][:, 0, 0] * torch.exp2(ln0)

    def right_sweep(A, S, RLs):
        A, S = list(A), list(S)
        RR = rr_triv
        RRs = [None] * L
        RRs[L - 1] = rr_triv
        for n in range(L - 1, 0, -1):
            Bn = _project(RLs[n], phi[:, n], RR)
            Q, R = qr_fixed(Bn.reshape(B, D, d * D).transpose(1, 2))
            A[n] = Q.transpose(1, 2).reshape(B, D, d, D)
            sv = svdvals(R.transpose(1, 2))
            S[n] = sv / torch.clamp(sv[:, :1], min=tiny)
            RR, _ = _rescale(_mix_right(RR, phi[:, n], A[n]), zero)
            RRs[n - 1] = RR
        return A, S, RRs

    def left_sweep(A, S, RRs):
        A, S = list(A), list(S)
        RL, ln, diff, lnstate = rl0, zero, zero, zero
        RLs = [rl0]
        for n in range(L):
            Bn = _project(RL, phi[:, n], RRs[n])
            Q, R = qr_fixed(Bn.reshape(B, D * d, D))
            A[n] = Q.reshape(B, D, d, D)
            sv = svdvals(R)
            sv = sv / torch.clamp(sv[:, :1], min=tiny)
            diff = torch.maximum(diff, torch.sqrt(torch.sum(
                (S[n + 1] - sv) ** 2, dim=1)))
            S[n + 1] = sv
            # at the last site the right env is trivial, so |R[0,0]|*2^ln
            # is the norm of the projected state
            lnstate = ln + torch.log2(torch.clamp(R[:, 0, 0].abs(),
                                                  min=tiny))
            RL, ln = _rescale(_mix_left(RL, phi[:, n], A[n]), ln)
            RLs.append(RL)
        return A, S, RLs, diff, RL[:, 0, 0] * torch.exp2(ln), lnstate

    A, overlap, ln_state, sweeps = _alternate(
        A0, RLs, overlap, right_sweep, left_sweep, tol=tol,
        max_sweeps=max_sweeps)
    return MPS(A=A, lognorm=mps.lognorm + ln_state), overlap, sweeps


def compress(mps: MPS, Dmax: int, *, tolS: float, tolV: float,
             max_sweeps: int, graduate: bool = True):
    """Compress an MPS (typically the fat output of :func:`apply_mpo`) to
    bond Dmax with the reference's schedule: right-canonize and keep the
    result as the target, then with graduate truncation SVD to 4*Dmax
    (tolS/10), one variational sweep, SVD to 2*Dmax (tolS/2); finally SVD
    to Dmax (tolS) and up to ``max_sweeps`` variational sweeps. The
    padded bond shrinks between stages by slicing off exact zero
    channels. Returns (MPS(bond=Dmax), overlap, max_discarded, sweeps),
    each (B,)."""
    Dfat = mps.A.shape[2]
    mps, _ = canonize_right(mps)
    phi = mps.A                       # the target, right-canonical
    phi_lognorm = mps.lognorm
    disc_total = torch.zeros_like(phi_lognorm)
    if graduate:
        cap1 = min(4 * Dmax, Dfat)
        mps, disc = canonize_left(mps, compress=True, cap=cap1, tol=tolS / 10)
        disc_total = torch.maximum(disc_total, disc)
        mps = slice_bond(mps, cap1)
        mps, _, _ = variational_compress(mps, phi, tol=tolV, max_sweeps=1)
        cap2 = min(2 * Dmax, cap1)
        mps, disc = canonize_right(mps, compress=True, cap=cap2,
                                   tol=tolS / 2)
        disc_total = torch.maximum(disc_total, disc)
        mps = slice_bond(mps, cap2)
    cap = min(Dmax, mps.A.shape[2])
    mps, disc = canonize_left(mps, compress=True, cap=cap, tol=tolS)
    disc_total = torch.maximum(disc_total, disc)
    mps = slice_bond(mps, cap)
    # the variational sweeps rebuild the norm from the target's
    mps = mps._replace(lognorm=phi_lognorm)
    mps, overlap, sweeps = variational_compress(mps, phi, tol=tolV,
                                                max_sweeps=max_sweeps)
    return pad_bond(mps, Dmax), overlap, disc_total, sweeps


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


def _zipup_sketch(A, Wc, Dmax, rsvd, omega):
    """The sketch (L, n, k) that the zip-up of A (B, L, D, d, D) by the
    oriented row Wc at bond Dmax truncates with, on A's device and in its
    dtype; None where it takes the exact SVD (``rsvd`` off, or a core
    under twice the sketch's rank: tnax's rule). ``omega`` as
    :func:`zipup_apply` takes it."""
    L, D = A.shape[1], A.shape[2]
    lh, du = Wc.shape[2], Wc.shape[5]
    rows, cols = Dmax * du, D * lh
    k_sketch = min(min(rows, cols), Dmax + 32)
    if not (check_rsvd(rsvd) and min(rows, cols) >= 2 * k_sketch):
        return None
    if omega is None:
        omega = sketch_omega(L, cols, k_sketch, A.dtype, A.device)
    elif callable(omega):
        omega = omega(L, cols, k_sketch)
    if tuple(omega.shape) != (L, cols, k_sketch):
        raise ValueError(f"sketch shape {tuple(omega.shape)} != "
                         f"{(L, cols, k_sketch)}")
    return omega.to(device=A.device, dtype=A.dtype)


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
    omega = _zipup_sketch(mps.A, Wc, Dmax, rsvd, omega)
    use_rsvd = omega is not None

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
    rule (see :func:`_alternate`). Returns (MPS, overlap (B,), sweeps
    (B,) int64).

    Float32 CUDA tensors at K5's shapes (``kernels.polish.engages``: the
    balancing ladder's bonds of 8 and legs of 16) run the whole polish in
    one launch of K5, each lane to its own stop on the card; everything
    else runs :func:`variational_implicit_plain`.
    """
    Wc = _orient_mpo(W, conj)
    if _polish.engages(mps.A, phi_A, Wc):
        A, overlap, ln_state, sweeps = _polish_k5(mps.A, phi_A, Wc, tol,
                                                  max_sweeps)
    else:
        A, overlap, ln_state, sweeps = variational_implicit_plain(
            mps.A, phi_A, Wc, tol=tol, max_sweeps=max_sweeps)
    return MPS(A=A, lognorm=mps.lognorm + ln_state), overlap, sweeps


def _polish_k5(A0, phi_A, Wc, tol, max_sweeps):
    """K5's polish with the stage clock's counters: when a clock records,
    ``variational_s`` runs from a read before the launch to the read of
    the most sweeps any lane ran (``passes``) after it, and
    ``polish_k5`` counts the row; otherwise nothing waits."""
    rec = config.recording()
    if rec is None:
        return _polish.polish_row(A0, phi_A, Wc, tol=tol,
                                  max_sweeps=max_sweeps)
    rec.read(_sync, A0.device)
    start = rec.read_end
    out = _polish.polish_row(A0, phi_A, Wc, tol=tol, max_sweeps=max_sweeps)
    rec.count("passes", rec.read(int, out[3].max()))
    rec.count("variational_s", rec.read_end - start)
    rec.count("polish_k5", 1)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def variational_implicit_plain(A0, phi_A, Wc, *, tol: float,
                               max_sweeps: int):
    """The polish of :func:`variational_implicit` in plain torch, for any
    shapes, dtypes and devices: A0 (B, L, Dn, du, Dn) left-canonical,
    phi_A (B, L, Do, d, Do), Wc (B, L, l, d, r, u) oriented. One host
    read a pass (:func:`_alternate`). Returns (A, overlap (B,), ln_state
    (B,), sweeps (B,) int64); K5 computes the same."""
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

    FLs = [fl0]
    F, ln0 = fl0, zero
    for n in range(L):
        F, ln0 = _rescale(upd_left(F, phi_A[:, n], Wc[:, n], A0[:, n]), ln0)
        FLs.append(F)
    overlap = FLs[L][:, 0, 0, 0] * torch.exp2(ln0)

    def right_sweep(A, S, FLs):
        A, S = list(A), list(S)
        FR = fr0
        FRs = [None] * L
        FRs[L - 1] = fr0
        for n in range(L - 1, 0, -1):
            Bn = project(FLs[n], phi_A[:, n], Wc[:, n], FR)
            Q, R = qr_fixed(Bn.reshape(B, Dn, du * Dn).transpose(1, 2))
            A[n] = Q.transpose(1, 2).reshape(B, Dn, du, Dn)
            sv = svdvals(R.transpose(1, 2))
            S[n] = sv / torch.clamp(sv[:, :1], min=tiny)
            FR, _ = _rescale(upd_right(FR, phi_A[:, n], Wc[:, n], A[n]),
                             zero)
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
            sv = svdvals(R)
            sv = sv / torch.clamp(sv[:, :1], min=tiny)
            diff = torch.maximum(diff, torch.sqrt(torch.sum(
                (S[n + 1] - sv) ** 2, dim=1)))
            S[n + 1] = sv
            # at the last site the right env is trivial, so |R[0,0]|*2^ln
            # is the norm of the projected state
            lnstate = ln + torch.log2(torch.clamp(R[:, 0, 0].abs(),
                                                  min=tiny))
            FL, ln = _rescale(upd_left(FL, phi_A[:, n], Wc[:, n], A[n]), ln)
            FLs.append(FL)
        return A, S, FLs, diff, FL[:, 0, 0, 0] * torch.exp2(ln), lnstate

    return _alternate(A0, FLs, overlap, right_sweep, left_sweep, tol=tol,
                      max_sweeps=max_sweeps)


def zipup_truncate(mps: MPS, Wc: torch.Tensor, Dmax: int, *, tolS: float,
                   rsvd: bool = True, omega=None):
    """The steps of :func:`compress_apply` before the polish, in plain
    torch: right-canonize ``mps``, zip up the oriented row Wc (B, L, l,
    d, r, u) at bond 2*Dmax (the sketch as ``rsvd`` and ``omega`` set it,
    the keep rule at tolS/10), one truncation sweep down to Dmax (tolS)
    and the slice. Returns (the right-canonical input MPS, the truncated
    MPS, discarded (B,)); K6 computes the same."""
    phi, _ = canonize_right(mps)
    out, disc = zipup_apply(phi, Wc, 2 * Dmax, conj=True, tol=tolS / 10,
                            rsvd=rsvd, omega=omega)
    out, disc2 = canonize_right(out, compress=True, cap=Dmax, tol=tolS)
    return phi, slice_bond(out, Dmax), torch.maximum(disc, disc2)


def _zipup_k6(mps, Wc, omega, tolS):
    """K6's steps with the stage clock's counter: a recording clock
    counts the row (``zipup_k6``); nothing waits either way."""
    phi_A, phi_ln, A0, disc = _zipup.zipup_row(mps.A, mps.lognorm, Wc,
                                               omega, tolS=tolS)
    rec = config.recording()
    if rec is not None:
        rec.count("zipup_k6", 1)
    return MPS(A=phi_A, lognorm=phi_ln), MPS(A=A0, lognorm=phi_ln), disc


def compress_apply(mps: MPS, W: torch.Tensor, Dmax: int, *, conj: bool,
                   tolS: float, tolV: float, max_sweeps: int,
                   rsvd: bool = True, omega=None):
    """Apply one MPO row W (B, L, l, d, r, u) to an MPS and compress to
    Dmax, fat-MPS-free: right-canonize, zip-up at bond 2*Dmax, one
    truncation sweep down to Dmax, then variational polish. Returns
    (MPS, overlap (B,), discarded (B,), sweeps (B,)).

    Float32 CUDA rows at K6's shapes (``kernels.zipup.engages``: the
    balancing ladder's bond of 8 and legs of 16, with the sketch) run the
    steps before the polish in one launch of K6; everything else runs
    :func:`zipup_truncate`.
    """
    eps = torch.finfo(mps.A.dtype).eps
    tolS = max(tolS, eps)
    tolV = max(tolV, 32 * eps)
    Wc = _orient_mpo(W, conj)
    omega = _zipup_sketch(mps.A, Wc, 2 * Dmax, rsvd, omega)
    if _zipup.engages(mps.A, Wc, omega):
        phi, out, disc = _zipup_k6(mps, Wc, omega, tolS)
    else:
        phi, out, disc = zipup_truncate(mps, Wc, Dmax, tolS=tolS, rsvd=rsvd,
                                        omega=omega)
    # the polish reconstructs the state norm from scratch, so it starts
    # from the target's lognorm, not the zip-up's
    out = out._replace(lognorm=phi.lognorm)
    out, overlap, sweeps = variational_implicit(
        out, phi.A, W, conj=conj, tol=tolV, max_sweeps=max_sweeps)
    return out, overlap, disc, sweeps


# ---------------------------------------------------------------------------
# the MPS API: construction, expectation values, measurements
# ---------------------------------------------------------------------------

def _lift(single, *ts):
    """The tensors ``ts`` with a leading instance axis added where
    ``single`` (tnax's unbatched shapes are a batch of one)."""
    return [t[None] if single else t for t in ts]


def _operator(O, A, shape):
    """A site operator (tensor or array) on A's device and dtype,
    broadcast to ``shape``."""
    return torch.as_tensor(O, device=A.device).to(A.dtype).expand(shape)


def _torch_dtype(dtype):
    """A torch dtype from a torch or NumPy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def init_mps(L: int, D: int, d: int, dtype, initial: str = "X",
             canonize: str = "left", seed: int = 0, valid_D: int = None,
             device=None) -> MPS:
    """A padded MPS (A (L, D, d, D), scalar lognorm), as tnax's
    ``init_mps``: 'X' (maximally mixed product), 'Z' (basis state 0),
    'randR' (uniform real in [-1, 1]), 'randC' (complex128, float64
    lognorm; ``dtype`` does not apply). ``valid_D`` bounds the populated
    bond channels (default D). The random entries are NumPy's
    ``default_rng(seed)`` draws in tnax's order, so both packages start
    from the same state. ``canonize`` is 'left', 'right' or anything else
    for none. On CUDA unless ``device`` is given."""
    device = config.resolve_device(device)
    vD = min(valid_D or D, D)
    # ragged bond dims capped by the distance to the edges
    dims = [min(d ** n, d ** (L - n), vD) for n in range(L + 1)]
    rng = np.random.default_rng(seed)
    A = np.zeros((L, D, d, D),
                 dtype=np.complex128 if initial == "randC" else np.float64)
    for n in range(L):
        dl, dr = dims[n], dims[n + 1]
        if initial == "X":
            A[n, 0, :, 0] = 1.0 / np.sqrt(d)
        elif initial == "Z":
            A[n, 0, 0, 0] = 1.0
        elif initial == "randR":
            A[n, :dl, :, :dr] = 2 * rng.random((dl, d, dr)) - 1
        elif initial == "randC":
            A[n, :dl, :, :dr] = (2 * rng.random((dl, d, dr)) - 1) \
                + 1j * (2 * rng.random((dl, d, dr)) - 1)
        else:
            raise ValueError(f"unknown initial {initial!r}")
    dtype = torch.complex128 if initial == "randC" else _torch_dtype(dtype)
    out = MPS(A=torch.as_tensor(A, device=device).to(dtype),
              lognorm=torch.zeros((), dtype=dtype.to_real(), device=device))
    if canonize == "left":
        out, _ = canonize_left(out)
    elif canonize == "right":
        out, _ = canonize_right(out)
    return out


def identity_mpo(L: int, lh: int, d: int, dtype, device=None):
    """Stacked identity MPO (L, lh, d, lh, d), legs (l, out, r, in)."""
    W = torch.zeros((L, lh, d, lh, d), dtype=_torch_dtype(dtype),
                    device=config.resolve_device(device))
    W[:, 0, :, 0, :] = torch.eye(d, dtype=W.dtype, device=W.device)
    return W


def mpo_from_block(M: torch.Tensor, dout: int, din: int) -> torch.Tensor:
    """One MPO tensor (l, out, r, in) from a block matrix."""
    sout, sin = M.shape
    return M.reshape(sout // dout, dout, sin // din, din)


def _mpo_left(F, b, Wn, k):
    T = torch.einsum("zblk,zkdm->zbldm", F, k)
    T = torch.einsum("zbldm,zlerd->zberm", T, Wn)
    return torch.einsum("zberm,zbec->zcrm", T, b)


def _mpo_right(F, b, Wn, k):
    T = torch.einsum("zkdm,zcrm->zkdcr", k, F)
    T = torch.einsum("zkdcr,zlerd->zkecl", T, Wn)
    return torch.einsum("zkecl,zbec->zblk", T, b)


def _mpo_envs(bra_A, W, ket_A, n):
    """Batched left/right environments (B, Db, lh, Dk) of <bra| W |ket>
    around site n (n = L: FL is the whole sandwich)."""
    B, L, Db = bra_A.shape[:3]
    Dk, lh = ket_A.shape[2], W.shape[2]
    FL = torch.zeros((B, Db, lh, Dk), dtype=ket_A.dtype, device=ket_A.device)
    FL[:, 0, 0, 0] = 1.0
    FR = FL.clone()
    for m in range(n):
        FL = _mpo_left(FL, bra_A[:, m], W[:, m], ket_A[:, m])
    for m in range(L - 1, n, -1):
        FR = _mpo_right(FR, bra_A[:, m], W[:, m], ket_A[:, m])
    return FL, FR


def expectation_mpo(bra_A, W, ket_A):
    """<bra| W |ket> for a stacked MPO W (L, l, out, r, in): out contracts
    the bra, in the ket. Unbatched (A (L, D, d, D)) or batched (B, ...)
    arguments; a scalar or (B,)."""
    single = bra_A.dim() == 4
    bra_A, W, ket_A = _lift(single, bra_A, W, ket_A)
    FL, _ = _mpo_envs(bra_A, W, ket_A, bra_A.shape[1])
    return _unlift(FL[:, 0, 0, 0], single)


def mpo_envs_at(bra_A, W, ket_A, n: int):
    """Left/right MPO-sandwich environments around site ``n``: FL
    contracts sites 0..n-1 of <bra| W |ket>, FR sites n+1..L-1; legs
    (bra, mpo, ket)."""
    single = bra_A.dim() == 4
    FL, FR = _mpo_envs(*_lift(single, bra_A, W, ket_A), n)
    return _unlift(FL, single), _unlift(FR, single)


def expectation_1mpo_mix(bra_A, W, ket_A, n: int, Wn):
    """<bra| W |ket> with the MPO tensor at site ``n`` replaced by ``Wn``
    (l, out, r, in)."""
    single = bra_A.dim() == 4
    return _unlift(expectation_list_1mpo_mix(
        *_lift(single, bra_A, W, ket_A), n,
        (Wn[None] if single else Wn)[:, None])[:, 0], single)


def expectation_list_1mpo_mix(bra_A, W, ket_A, n: int, Wns):
    """:func:`expectation_1mpo_mix` for a stack of replacements ``Wns``
    (N, l, out, r, in): the environments are built once. Returns (N,)
    (or (B, N))."""
    single = bra_A.dim() == 4
    bra_A, W, ket_A, Wns = _lift(single, bra_A, W, ket_A, Wns)
    FL, FR = _mpo_envs(bra_A, W, ket_A, n)
    T = torch.einsum("zblk,zkdm->zbldm", FL, ket_A[:, n])
    T = torch.einsum("zbldm,znlerd->znberm", T, Wns)
    T = torch.einsum("znberm,zbec->zncrm", T, bra_A[:, n])
    return _unlift(torch.einsum("zncrm,zcrm->zn", T, FR), single)


def mps_dot(phi_A, psi_A):
    """<phi|psi> of two stacked MPS (no lognorm factors, no conjugation)."""
    single = phi_A.dim() == 4
    phi_A, psi_A = _lift(single, phi_A, psi_A)
    B, L, Dp = phi_A.shape[:3]
    rl = _e00(B, psi_A.shape[2], Dp, psi_A.dtype, psi_A.device)
    for n in range(L):
        rl = _mix_left(rl, phi_A[:, n], psi_A[:, n])
    return _unlift(rl[:, 0, 0], single)


def _norm_envs(A):
    """Right environments of <A|A>: RRs[n] contracts sites n..L-1
    (RRs[L] trivial); RRs[0][:, 0, 0] is the squared norm."""
    B, L, D = A.shape[:3]
    RRs = [None] * (L + 1)
    RRs[L] = _e00(B, D, D, A.dtype, A.device)
    for n in range(L - 1, -1, -1):
        RRs[n] = torch.einsum("zadb,zbc,zedc->zae", A[:, n], RRs[n + 1],
                              A[:, n])
    return RRs


def _absorb(rl, a):
    return torch.einsum("zxa,zadb,zxdc->zcb", rl, a, a)


def _one_site(rl, a, On, rr):
    return torch.einsum("zxa,zadb,zed,zxec,zbc->z", rl, a, On, a, rr)


def measure_O1(A, O):
    """<psi|O_n|psi> for a one-site operator at every site, normalized.
    A (L, D, d, D); O (d, d) or (L, d, d). Returns (L,)."""
    single = A.dim() == 4
    (A,) = _lift(single, A)
    B, L, D, d, _ = A.shape
    O = _operator(O, A, (B, L, d, d))
    RRs = _norm_envs(A)
    rl = _e00(B, D, D, A.dtype, A.device)
    vals = []
    for n in range(L):
        vals.append(_one_site(rl, A[:, n], O[:, n], RRs[n + 1]))
        rl = _absorb(rl, A[:, n])
    return _unlift(torch.stack(vals, dim=1) / RRs[0][:, :1, 0], single)


def measure_O2(A, O):
    """<psi|O_{n,n+1}|psi> for a two-site operator at every bond,
    normalized. O (d, d, d, d) or (L-1, d, d, d, d) with legs (out1,
    out2, in1, in2). Returns (L-1,)."""
    single = A.dim() == 4
    (A,) = _lift(single, A)
    B, L, D, d, _ = A.shape
    O = _operator(O, A, (B, L - 1, d, d, d, d))
    RRs = _norm_envs(A)
    rl = _e00(B, D, D, A.dtype, A.device)
    out = []
    for n in range(L - 1):
        AA = torch.einsum("zadb,zbec->zadec", A[:, n], A[:, n + 1])
        T = torch.einsum("zxa,zadec->zxdec", rl, AA)
        # bra phys = O's out legs (p, q), ket phys = its in legs (d, e)
        out.append(torch.einsum("zxdec,zpqde,zxpqg,zcg->z", T, O[:, n], AA,
                                RRs[n + 2]))
        rl = _absorb(rl, A[:, n])
    return _unlift(torch.stack(out, dim=1) / RRs[0][:, :1, 0], single)


def measure_correlations(A, O):
    """All two-point correlators <psi|O_n O_m|psi>, normalized. O (d, d)
    or (L, d, d). Returns (L, L)."""
    single = A.dim() == 4
    (A,) = _lift(single, A)
    B, L, D, d, _ = A.shape
    O = _operator(O, A, (B, L, d, d))
    RRs = _norm_envs(A)
    rl = _e00(B, D, D, A.dtype, A.device)
    out = [[None] * L for _ in range(L)]
    RLO = [None] * L          # RLO[m]: O at site m, absorbed up to here
    for n in range(L):
        a, On = A[:, n], O[:, n]
        out[n][n] = _one_site(rl, a, On, RRs[n + 1])
        for m in range(n):
            out[m][n] = out[n][m] = _one_site(RLO[m], a, On, RRs[n + 1])
            RLO[m] = _absorb(RLO[m], a)
        RLO[n] = torch.einsum("zxa,zadb,zed,zxec->zcb", rl, a, On, a)
        rl = _absorb(rl, a)
    out = torch.stack([torch.stack(row, dim=1) for row in out], dim=1)
    return _unlift(out / RRs[0][:, 0, 0, None, None], single)


def describe(mps: MPS) -> str:
    """A one-line summary: length, padded shape, the rank of each site
    tensor (singular values above 1e-12 of the largest) and the lognorm;
    one string per instance (a list) for a batched MPS."""
    mps_b, single = _lift_mps(mps)
    B, L, Dl, d, Dr = mps_b.A.shape
    sv = torch.linalg.svdvals(mps_b.A.reshape(B, L, Dl * d, Dr)).cpu()
    ranks = (sv > sv[..., :1] * 1e-12).sum(-1) * (sv[..., 0] > 0)
    ln = mps_b.lognorm.cpu()
    out = [f"L={L} pad(D={Dl}, d={d}) bond ranks={ranks[b].tolist()} "
           f"lognorm={float(ln[b]):.3f}" for b in range(B)]
    return out[0] if single else out
