"""Triton kernel K3: the marginal epilogue, one program per branch row of
each instance (a grid of B * M programs).

Replaces the elementwise tail of tnax/engine.py ``marginal_step`` (after
its two GEMMs) and ``row_step``'s log2-probabilities (parallel.py
``logP``/``probf``): per branch m, gather g[p] = T2[m, drindex[p]] and
the Boltzmann column lB[p, lidx[m], uidx[m]], subtract the column's max,
exponentiate, mask the invalid states, clamp negative marginals,
normalize, take log2 and add the branch's log2-probability. Program
(b, m) reads instance b's tables and its count of valid states from
device tensors, so one launch serves a whole fleet.

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
def _marginal_epilogue_kernel(T2, lB, dr, lidx, uidx, prob, valid, nvalid,
                              consts, probf, mPn_out, M, Np, lhlv, lv,
                              t2_bstride, t2_stride, BLOCK: tl.constexpr):
    pid = tl.program_id(0)          # = b * M + m
    b = pid // M
    m = pid - b * M
    p = tl.arange(0, BLOCK)
    inb = p < Np
    NEG = tl.load(consts)        # -1e30 in the working dtype
    BIG = tl.load(consts + 1)    # the dtype's largest finite value
    nv = tl.load(nvalid + b)
    li = tl.load(lidx + pid)
    ui = tl.load(uidx + pid)
    drp = tl.load(dr + b * Np + p, mask=inb, other=0)
    g = tl.load(T2 + b * t2_bstride + m * t2_stride + drp, mask=inb,
                other=0.0)
    lBlu = tl.load(lB + (b * Np + p) * lhlv + li * lv + ui, mask=inb,
                   other=-float("inf"))
    shift = tl.max(lBlu, axis=0)
    shift = tl.where((shift >= -BIG) & (shift <= BIG), shift, 0.0)
    Pn = g * libdevice.exp(lBlu - shift)
    smask = p < nv
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
    uniform = smask.to(Pn.dtype) / nv.to(Pn.dtype)
    Pn = tl.where(good, Pn / nrm, uniform)
    mPn = tl.where(good, mPn / nrm, -1.0)
    logP = tl.where(Pn > 0, libdevice.log2(tl.where(Pn > 0, Pn, 1.0)), NEG)
    v = tl.load(valid + pid)
    pm = tl.load(prob + pid)
    out = tl.where(v != 0, pm + logP, NEG)
    tl.store(probf + pid * Np + p, out, mask=inb)
    tl.store(mPn_out + pid, mPn)


@functools.lru_cache(maxsize=8)
def _consts(neg, dtype, device):
    """[NEG, dtype max] on the device, made once: a fresh host-to-device
    copy at every launch would be a host sync in the per-site loop."""
    return torch.tensor([neg, torch.finfo(dtype).max], dtype=dtype,
                        device=device)


def launch(T2, lB, drindex, lidx, uidx, nvalid, prob, valid, neg):
    """Run the kernel; arguments as ``marginal.marginal_epilogue_plain``,
    with ``nvalid`` a (B,) tensor on the card. Returns (probf (B, M, Np),
    mPn (B, M))."""
    B, M = T2.shape[:2]
    Np, lh, lv = lB.shape[1:]
    dtype = T2.dtype
    if dtype not in (torch.float32, torch.float64) or lB.dtype != dtype \
            or prob.dtype != dtype:
        raise ValueError(f"marginal_epilogue: unsupported dtypes "
                         f"{T2.dtype}, {lB.dtype}, {prob.dtype}")
    if T2.shape != (B, M, lh * lv) or lB.shape[0] != B or \
            drindex.shape != (B, Np) or lidx.shape != (B, M) or \
            uidx.shape != (B, M) or prob.shape != (B, M) or \
            valid.shape != (B, M):
        raise ValueError("marginal_epilogue: inconsistent shapes")
    if not torch.is_tensor(nvalid) or nvalid.shape != (B,) or \
            nvalid.device != T2.device:
        raise ValueError("marginal_epilogue: nvalid must be a (B,) tensor "
                         "on the card")
    T2 = T2.contiguous()
    lB = lB.contiguous()
    dev = T2.device
    consts = _consts(neg, dtype, dev)
    probf = torch.empty((B, M, Np), dtype=dtype, device=dev)
    mPn = torch.empty((B, M), dtype=dtype, device=dev)
    BLOCK = max(16, triton.next_power_of_2(Np))

    def i32(t):
        return t.to(torch.int32).contiguous()

    _marginal_epilogue_kernel[(B * M,)](
        T2, lB, i32(drindex), i32(lidx), i32(uidx), prob.contiguous(),
        valid.to(torch.int8).contiguous(), i32(nvalid), consts, probf, mPn,
        M, Np, lh * lv, lv, T2.stride(0), T2.stride(1), BLOCK=BLOCK,
        num_warps=4 if BLOCK <= 512 else 8)
    return probf, mPn
