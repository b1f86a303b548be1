"""Carry state across from tnax: its arrays as NumPy in, the port's
tensors out. Used to start both packages from the same state.

The port's tensors carry a leading instance axis. Each function takes
the arrays of one tnax instance, which become a batch of one, or tnax's
stacked fleet arrays (its vmapped outputs), which keep their axis. A
Solver's droplet store is host data in both packages and comes across as
it is (:func:`droplet_store`)."""

from __future__ import annotations

import numpy as np
import torch

from . import spectrum
from .bmps import MPS

DEG_BITS = 12  # tnax's degeneracy limbs are base 2^12 int32


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.array(a), device=device)
    return t if dtype is None else t.to(dtype)


def _batch(t, single_ndim):
    """Add the instance axis to one instance's tensor."""
    return t[None] if t.dim() == single_ndim else t


def gauges(X, device, dtype):
    """tnax gauges dict (Xl, Xr, Xu, Xd), each (Ny, Nx, l) or stacked
    (B, Ny, Nx, l) -> tensors (B, Ny, Nx, l)."""
    return {k: _batch(_t(X[k], device, dtype), 3)
            for k in ("Xl", "Xr", "Xu", "Xd")}


def mps(A, lognorm, device, dtype):
    """tnax MPS (stacked ``A`` (L, D, d, D) and scalar ``lognorm``, or a
    fleet's (B, L, D, d, D) and (B,)) -> :class:`MPS` with the instance
    axis. ``dtype`` is the real precision: a complex ``A`` (tnax's
    'randC') keeps its phase in the complex dtype of that precision, and
    the lognorm is real."""
    A = _t(A, device)
    A = A.to(dtype.to_complex() if A.is_complex() else dtype)
    return MPS(A=_batch(A, 4),
               lognorm=_batch(_t(lognorm, device, dtype), 0))


def deg_decode(limbs):
    """(..., limbs) int32 base-2^12 degeneracy limbs -> int64 counts
    (tnax ``parallel.deg_decode``)."""
    limbs = np.asarray(limbs).astype(np.int64)
    shifts = np.int64(1) << (DEG_BITS * np.arange(limbs.shape[-1],
                                                  dtype=np.int64))
    return (limbs * shifts).sum(axis=-1)


def beam(b, device, dtype):
    """tnax beam payload (RL, vind, states, Eng, prob, deg limbs, valid,
    aidx) of one instance ((M, ...) arrays) or of a fleet ((B, M, ...))
    -> the port's beam (B, M, ...), with float64 energies and int64
    degeneracies."""
    def bt(a, dt, single_ndim):
        return _batch(_t(a, device, dt), single_ndim)

    return dict(
        RL=bt(b["RL"], dtype, 2),
        vind=bt(b["vind"], torch.int32, 2),
        states=bt(b["states"], torch.int32, 2),
        Eng=bt(b["Eng"], torch.float64, 1),
        prob=bt(b["prob"], dtype, 1),
        deg=bt(deg_decode(b["deg"]), torch.int64, 1),
        valid=bt(b["valid"], torch.bool, 1),
        aidx=bt(b["aidx"], torch.int64, 1),
    )


def droplet_store(ins, store):
    """Put a tnax Solver's droplet store into the port Solver ``ins``:
    ``store`` maps d, invd, el, free_d and excitations_encoding, and for
    encodings 2 and 3 adj (dense) and xor2ind, as tnax holds them (NumPy
    arrays and tuples); energy and states, if present, come along. The
    adjacency's bitset tables are rebuilt, so the port's decoder can
    expand a store that tnax built."""
    for k in ("d", "invd", "el", "free_d", "excitations_encoding",
              "energy", "states"):
        if k in store:
            setattr(ins, k, store[k])
    ins._keyl = {(p.tobytes(), s.tobytes()): k
                 for k, (p, s) in ins.d.items()}
    ins._shape_masks = {}
    if ins.excitations_encoding > 1:
        ins.adj = np.asarray(store["adj"], dtype=bool)
        ins.xor2ind = [list(tab) for tab in store["xor2ind"]]
        spectrum.adjacency_tables(ins)
