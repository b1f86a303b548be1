"""Triton kernel K3: the marginal epilogue, one program per branch row.

Replaces the elementwise tail of tnax/engine.py ``marginal_step`` (after
its two GEMMs) and ``row_step``'s log2-probabilities (parallel.py
``logP``/``probf``): per branch m, gather g[p] = T2[m, drindex[p]] and
the Boltzmann column lB[p, lidx[m], uidx[m]], subtract the column's max,
exponentiate, mask the invalid states, clamp negative marginals,
normalize, take log2 and add the branch's log2-probability.

What bounds it on the card: memory traffic and launch count, not
arithmetic. Eager PyTorch runs this tail as some thirty launches over
(M, Np) temporaries, each a full round trip to device memory. Here one
program holds its branch's Np <= BLOCK values in registers, does the two
row reductions (max, then min/count/sum) in place, and writes probf once:
about 3 * M * Np words of traffic. Exponentials and logarithms come from
libdevice, which is accurate in float64 (rtol 1e-12 against the plain
version) as well as float32.

Imported only by ``marginal.marginal_epilogue`` on a CUDA tensor: this
module imports ``triton`` at the top.
"""

from __future__ import annotations

import functools

import torch
import triton
import triton.language as tl
import triton.language.extra.libdevice as libdevice


@triton.jit
def _marginal_epilogue_kernel(T2, lB, dr, lidx, uidx, prob, valid, consts,
                              probf, mPn_out, nvalid, Np, lhlv, lv, t2_stride,
                              BLOCK: tl.constexpr):
    m = tl.program_id(0)
    p = tl.arange(0, BLOCK)
    inb = p < Np
    NEG = tl.load(consts)        # -1e30 in the working dtype
    BIG = tl.load(consts + 1)    # the dtype's largest finite value
    li = tl.load(lidx + m)
    ui = tl.load(uidx + m)
    drp = tl.load(dr + p, mask=inb, other=0)
    g = tl.load(T2 + m * t2_stride + drp, mask=inb, other=0.0)
    lBlu = tl.load(lB + p * lhlv + li * lv + ui, mask=inb,
                   other=-float("inf"))
    shift = tl.max(lBlu, axis=0)
    shift = tl.where((shift >= -BIG) & (shift <= BIG), shift, 0.0)
    Pn = g * libdevice.exp(lBlu - shift)
    smask = p < nvalid
    Pn = tl.where(smask, Pn, 0.0)
    mPn = tl.min(tl.where(smask, Pn, BIG), axis=0)
    neg = mPn < 0
    amin = tl.abs(mPn)
    clip = neg & smask & (Pn < amin)
    Pn = tl.where(clip, amin, Pn)
    nclip = tl.sum(clip.to(tl.int32), axis=0)
    mPn = tl.where(neg, mPn * nclip.to(Pn.dtype), mPn)
    no = tl.sum(Pn, axis=0)
    good = no > 0
    nrm = tl.where(good, no, 1.0)
    # nvalid may arrive as a constexpr (Triton specializes ints equal to 1)
    uniform = smask.to(Pn.dtype) / (nvalid * 1.0)
    Pn = tl.where(good, Pn / nrm, uniform)
    mPn = tl.where(good, mPn / nrm, -1.0)
    logP = tl.where(Pn > 0, libdevice.log2(tl.where(Pn > 0, Pn, 1.0)), NEG)
    v = tl.load(valid + m)
    pm = tl.load(prob + m)
    out = tl.where(v != 0, pm + logP, NEG)
    tl.store(probf + m * Np + p, out, mask=inb)
    tl.store(mPn_out + m, mPn)


@functools.lru_cache(maxsize=8)
def _consts(neg, dtype, device):
    """[NEG, dtype max] on the device, made once: a fresh host-to-device
    copy at every launch would be a host sync in the per-site loop."""
    return torch.tensor([neg, torch.finfo(dtype).max], dtype=dtype,
                        device=device)


def launch(T2, lB, drindex, lidx, uidx, nvalid, prob, valid, neg):
    """Run the kernel; arguments as ``marginal.marginal_epilogue_plain``.
    Returns (probf (M, Np), mPn (M,))."""
    M = T2.shape[0]
    Np, lh, lv = lB.shape
    dtype = T2.dtype
    if dtype not in (torch.float32, torch.float64) or lB.dtype != dtype \
            or prob.dtype != dtype:
        raise ValueError(f"marginal_epilogue: unsupported dtypes "
                         f"{T2.dtype}, {lB.dtype}, {prob.dtype}")
    if T2.shape[1] != lh * lv or drindex.shape != (Np,) or \
            lidx.shape != (M,) or uidx.shape != (M,) or \
            prob.shape != (M,) or valid.shape != (M,):
        raise ValueError("marginal_epilogue: inconsistent shapes")
    T2 = T2.contiguous()
    lB = lB.contiguous()
    dev = T2.device
    consts = _consts(neg, dtype, dev)
    probf = torch.empty((M, Np), dtype=dtype, device=dev)
    mPn = torch.empty((M,), dtype=dtype, device=dev)
    BLOCK = max(16, triton.next_power_of_2(Np))
    _marginal_epilogue_kernel[(M,)](
        T2, lB, drindex.to(torch.int32).contiguous(),
        lidx.to(torch.int32).contiguous(), uidx.to(torch.int32).contiguous(),
        prob.contiguous(), valid.to(torch.int8).contiguous(), consts, probf,
        mPn, int(nvalid), Np, lh * lv, lv, T2.stride(0), BLOCK=BLOCK,
        num_warps=4 if BLOCK <= 512 else 8)
    return probf, mPn
