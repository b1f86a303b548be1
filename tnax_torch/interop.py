"""Carry state across from tnax: its arrays as NumPy in, the port's
tensors out. Used to start both packages from the same state."""

from __future__ import annotations

import numpy as np
import torch

from .bmps import MPS

DEG_BITS = 12  # tnax's degeneracy limbs are base 2^12 int32


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.array(a), device=device)
    return t if dtype is None else t.to(dtype)


def gauges(X, device, dtype):
    """tnax gauges dict (Xl, Xr, Xu, Xd) -> tensors."""
    return {k: _t(X[k], device, dtype) for k in ("Xl", "Xr", "Xu", "Xd")}


def mps(A, lognorm, device, dtype):
    """tnax boundary MPS (stacked ``A``, ``lognorm``) -> :class:`MPS`."""
    return MPS(A=_t(A, device, dtype), lognorm=_t(lognorm, device, dtype))


def deg_decode(limbs):
    """(..., limbs) int32 base-2^12 degeneracy limbs -> int64 counts
    (tnax ``parallel.deg_decode``)."""
    limbs = np.asarray(limbs).astype(np.int64)
    shifts = np.int64(1) << (DEG_BITS * np.arange(limbs.shape[-1],
                                                  dtype=np.int64))
    return (limbs * shifts).sum(axis=-1)


def beam(b, device, dtype):
    """tnax beam payload (RL, vind, states, Eng, prob, deg limbs, valid,
    aidx) -> the port's beam, with float64 energies and int64
    degeneracies."""
    return dict(
        RL=_t(b["RL"], device, dtype),
        vind=_t(b["vind"], device, torch.int32),
        states=_t(b["states"], device, torch.int32),
        Eng=_t(b["Eng"], device, torch.float64),
        prob=_t(b["prob"], device, dtype),
        deg=_t(deg_decode(b["deg"]), device, torch.int64),
        valid=_t(b["valid"], device, torch.bool),
        aidx=_t(b["aidx"], device, torch.int64),
    )
