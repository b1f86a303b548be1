"""K3: the marginal epilogue (``tnax.engine.marginal_step`` after its two
GEMMs, fused with ``row_step``'s log2-probabilities).

:func:`marginal_epilogue` launches the Triton kernel in
``marginal_triton.py`` for CUDA tensors and runs
:func:`marginal_epilogue_plain` for CPU tensors. Triton is imported
inside the launcher only.
"""

from __future__ import annotations

import torch

NEG = -1e30   # effectively -inf log2 probability (tnax.parallel.NEG)


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
    g = torch.gather(T2, 2, drindex.long()[:, None, :].expand(B, M, Np))
    col = (lidx.long() * lv + uidx.long())[:, None, :].expand(B, Np, M)
    lBlu = torch.gather(lB.reshape(B, Np, lh * lv), 2, col).transpose(1, 2)
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


def marginal_epilogue_plain(T2, lB, drindex, lidx, uidx, nvalid, prob,
                            valid):
    """:func:`marginal_pn_plain`, then probf = prob + log2(Pn) per branch
    (NEG where Pn <= 0 or the branch is invalid); prob and valid (B, M).
    Returns (probf (B, M, Np), mPn (B, M))."""
    Pn, mPn = marginal_pn_plain(T2, lB, drindex, lidx, uidx, nvalid)
    logP = torch.where(Pn > 0, torch.log2(torch.where(Pn > 0, Pn, 1.0)), NEG)
    probf = torch.where(valid[..., None], prob[..., None] + logP, NEG)
    return probf, mPn


def marginal_epilogue(T2, lB, drindex, lidx, uidx, nvalid, prob, valid):
    """The marginal epilogue; the Triton kernel on CUDA tensors (one
    launch for all B instances), the plain version on CPU tensors. See
    :func:`marginal_epilogue_plain`."""
    if T2.device.type == "cpu":
        return marginal_epilogue_plain(T2, lB, drindex, lidx, uidx, nvalid,
                                       prob, valid)
    if T2.device.type != "cuda":
        raise ValueError(f"marginal_epilogue: unsupported device "
                         f"{T2.device}")
    from . import marginal_triton
    out = marginal_triton.launch(T2, lB, drindex, lidx, uidx, nvalid, prob,
                                 valid, NEG)
    marginal_epilogue.launches += 1
    return out


marginal_epilogue.launches = 0
