"""K3: the marginal epilogue of the beam search
(``tnax.engine.marginal_step`` after its two GEMMs, fused with
``row_step``'s log2-probabilities and its per-instance reductions).

:func:`marginal_epilogue` launches the CUDA kernel in ``csrc/marginal.cu``
for CUDA tensors and runs :func:`marginal_epilogue_plain` for CPU tensors.
The epilogue reads the Boltzmann columns from ``lBT`` (B, lh, lv, Np), the
site's table ``lB`` (B, Np, lh, lv) with the states last
(:func:`boltzmann_columns`), so that a branch's column is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

NEG = -1e30     # effectively -inf log2 probability (tnax.parallel.NEG)
NP_MAX = 4096   # a block holds its rows of Np values in 48 KB of shared memory


def boltzmann_columns(lB):
    """``lB`` (..., Np, lh, lv) with the states last: (..., lh, lv, Np),
    contiguous, so column (l, u) of the site is one run of Np values."""
    return lB.movedim(-3, -1).contiguous()


def columns(lBT, lidx, uidx):
    """Each branch's Boltzmann column from the table with the states last,
    lBT (B, lh, lv, Np), and the branches' leg values lidx/uidx (B, M):
    (B, M, Np)."""
    B, lh, lv, Np = lBT.shape
    col = (lidx.long() * lv + uidx.long())[:, :, None].expand(-1, -1, Np)
    return torch.gather(lBT.reshape(B, lh * lv, Np), 1, col)


def _pn_from_columns(T2, lBlu, drindex, nvalid):
    """Normalized marginals from each branch's Boltzmann column lBlu
    (B, M, Np); see :func:`marginal_pn_plain`."""
    B, M, Np = lBlu.shape
    g = torch.gather(T2, 2, drindex.long()[:, None, :].expand(B, M, Np))
    shift = lBlu.amax(dim=2, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, 0.0)
    Pn = g * torch.exp(lBlu - shift)
    nvalid = nvalid.reshape(B, 1)
    smask = (torch.arange(Np, device=T2.device)[None, :] < nvalid)[:, None]
    Pn = torch.where(smask, Pn, 0.0)
    big = torch.finfo(Pn.dtype).max
    mPn = torch.where(smask, Pn, big).amin(dim=2)            # (B, M)
    neg = mPn < 0
    amin = mPn.abs()[..., None]
    clip = neg[..., None] & smask & (Pn < amin)
    Pn = torch.where(clip, amin, Pn)
    mPn = torch.where(neg, mPn * clip.sum(dim=2), mPn)
    no = Pn.sum(dim=2)
    good = no > 0
    uniform = smask.to(Pn.dtype) / nvalid[:, None].to(Pn.dtype)
    nrm = torch.where(good, no, 1.0)
    Pn = torch.where(good[..., None], Pn / nrm[..., None], uniform)
    mPn = torch.where(good, mPn / nrm, -1.0)
    return Pn, mPn


def marginal_pn_plain(T2, lB, drindex, lidx, uidx, nvalid):
    """Normalized conditional marginals from the contracted environments,
    for the branches of B instances.

    T2 (B, M, lv*lh) per-branch products, lB (B, Np, lh, lv) log-Boltzmann
    factors of the site, drindex (B, Np), lidx/uidx (B, M), nvalid (B,)
    valid states per instance (a tensor: instances of one shape may differ
    in it). Each branch's Boltzmann column is exponentiated after
    subtracting its own maximum; negative marginals are clamped to |min|
    and the count of clamped states scales the negativeness flag. Returns
    (Pn (B, M, Np), mPn (B, M)).
    """
    B, M = T2.shape[:2]
    Np, lh, lv = lB.shape[1:]
    col = (lidx.long() * lv + uidx.long())[:, None, :].expand(B, Np, M)
    lBlu = torch.gather(lB.reshape(B, Np, lh * lv), 2, col).transpose(1, 2)
    return _pn_from_columns(T2, lBlu, drindex, nvalid)


def marginal_epilogue_plain(T2, lBT, drindex, lidx, uidx, nvalid, prob,
                            valid, log2_cutoff):
    """The search's marginal epilogue for B instances: the marginals of
    :func:`marginal_pn_plain`, read from the transposed table lBT
    (B, lh, lv, Np), then probf = prob + log2(Pn) per branch (NEG where
    Pn <= 0 or the branch is invalid) and the reductions ``row_step``
    takes of them; prob and valid (B, M).

    Returns (probf (B, M, Np), mPn (B, M), pmax (B,) the maximum of probf,
    mq (B,) the minimum of mPn over valid branches and 0, mqc (B,) the
    same over the core branches: valid, with prob above the instance's best
    valid prob plus ``log2_cutoff``).
    """
    B, M = T2.shape[:2]
    Np = lBT.shape[-1]
    Pn, mPn = _pn_from_columns(T2, columns(lBT, lidx, uidx), drindex, nvalid)
    logP = torch.where(Pn > 0, torch.log2(torch.where(Pn > 0, Pn, 1.0)), NEG)
    probf = torch.where(valid[..., None], prob[..., None] + logP, NEG)
    # negativeness only from live branches, and (core) only from those
    # within the cutoff window of the best branch
    pmax = probf.reshape(B, M * Np).amax(dim=1)
    mq = torch.where(valid, mPn, 0.0).amin(dim=1)
    bmax = torch.where(valid, prob, NEG).amax(dim=1, keepdim=True)
    core = valid & (prob > bmax + log2_cutoff)
    mqc = torch.where(core, mPn, 0.0).amin(dim=1)
    return probf, mPn, pmax, mq, mqc


# the entry points' arguments: T2, lBT, drindex (pointer, batch stride
# each), lidx, uidx, nvalid (pointer, stride), prob, valid, B, M, Np, lv,
# lh*lv, log2_cutoff, NEG, five outputs, the reduction images, the stream
_ARGS = ((ctypes.c_void_p, ctypes.c_longlong) * 3
         + (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,)
         + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5
         + (ctypes.c_double,) * 2 + (ctypes.c_void_p,) * 7)


def marginal_epilogue(T2, lBT, drindex, lidx, uidx, nvalid, prob, valid,
                      log2_cutoff):
    """The marginal epilogue; the CUDA kernel on CUDA tensors (one launch
    for all B instances, one warp per branch), the plain version on CPU
    tensors. See :func:`marginal_epilogue_plain`. On the card drindex,
    lidx, uidx and nvalid are int64 and valid is bool, as the search holds
    them."""
    if T2.device.type == "cpu":
        return marginal_epilogue_plain(T2, lBT, drindex, lidx, uidx, nvalid,
                                       prob, valid, log2_cutoff)
    if T2.device.type != "cuda":
        raise ValueError(f"marginal_epilogue: unsupported device "
                         f"{T2.device}")
    B, M = T2.shape[:2]
    lh, lv, Np = lBT.shape[1:]
    dtype, dev = T2.dtype, T2.device
    if dtype not in (torch.float32, torch.float64) or lBT.dtype != dtype \
            or prob.dtype != dtype:
        raise ValueError(f"marginal_epilogue: T2, lBT and prob must share "
                         f"float32 or float64, got {T2.dtype}, {lBT.dtype}, "
                         f"{prob.dtype}")
    if T2.shape != (B, M, lh * lv) or lBT.shape[0] != B or \
            drindex.shape != (B, Np) or lidx.shape != (B, M) or \
            uidx.shape != (B, M) or nvalid.shape != (B,) or \
            prob.shape != (B, M) or valid.shape != (B, M):
        raise ValueError("marginal_epilogue: inconsistent shapes")
    if not 1 <= Np <= NP_MAX:
        raise ValueError(f"marginal_epilogue: the kernel takes 1..{NP_MAX} "
                         f"states, got {Np}")
    for t, dt in ((drindex, torch.int64), (lidx, torch.int64),
                  (uidx, torch.int64), (nvalid, torch.int64),
                  (valid, torch.bool)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"marginal_epilogue: expected {dt} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if lBT.device != dev or prob.device != dev:
        raise ValueError(f"marginal_epilogue: all inputs must lie on {dev}")
    # one instance's block of T2, lBT and drindex must be contiguous; the
    # instances may lie apart (the per-site slices of the search's stacks)
    if T2.stride()[1:] != (lh * lv, 1):
        T2 = T2.contiguous()
    if lBT.stride()[1:] != (lv * Np, Np, 1):
        lBT = lBT.contiguous()
    if drindex.stride(1) != 1:
        drindex = drindex.contiguous()
    lidx, uidx, prob, valid = (t.contiguous()
                               for t in (lidx, uidx, prob, valid))
    # probf, mPn, pmax, mq and mqc in one allocation
    out = torch.empty(B * (M * Np + M + 3), dtype=dtype, device=dev)
    probf = out[:B * M * Np].view(B, M, Np)
    mPn = out[B * M * Np:B * (M * Np + M)].view(B, M)
    pmax, mq, mqc = out[B * (M * Np + M):].view(3, B)
    red = torch.empty(3 * B + 1, dtype=torch.int64, device=dev)
    fn = build.fn("marginal", "tnax_marginal_f64" if dtype == torch.float64
                  else "tnax_marginal_f32", _ARGS)
    err = fn(T2.data_ptr(), T2.stride(0), lBT.data_ptr(), lBT.stride(0),
             drindex.data_ptr(), drindex.stride(0), lidx.data_ptr(),
             uidx.data_ptr(), nvalid.data_ptr(), nvalid.stride(0),
             prob.data_ptr(), valid.data_ptr(), B, M, Np, lv, lh * lv,
             float(log2_cutoff), NEG,
             *(t.data_ptr() for t in (probf, mPn, pmax, mq, mqc, red)),
             build.raw_stream(dev))
    build.check(build.load("marginal"), err, "marginal_epilogue")
    marginal_epilogue.launches += 1
    return probf, mPn, pmax, mq, mqc


marginal_epilogue.launches = 0
