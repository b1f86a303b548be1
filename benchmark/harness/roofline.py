"""The least time the card could take for a kernel call, from its shapes.

Frozen copy of ``chip_smoke.py``'s roofline arithmetic:
``HBM_BYTES_PER_S`` and ``OPS_PER_S`` (lines 133-136), ``nbytes`` and
``gathered_bytes`` (lines 172-186), ``bound`` (lines 259-265), and the
operation counts of its K2 and K3 checks (lines 403-408 and 458-463):
inputs and outputs counted once at the HBM rate, operations at the
dtype's peak, the larger of the two. Peaks are one H100 SXM's, from
NVIDIA's data sheet, at the full 700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 67e12, "float64": 34e12}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def gathered_bytes(T2, lBT, drindex, lidx, uidx, nvalid, torch):
    """Bytes K3 must read of its gathered inputs: the Np-state Boltzmann
    column lBT[b, l, u, :] once for each distinct (l, u) pair of instance
    b, the valid states' entries of each branch's row of T2, and the
    64-bit indices."""
    lv, Np = lBT.shape[2], lBT.shape[3]
    pairs = sum(int(torch.unique(lidx[b].long() * lv + uidx[b].long()).numel())
                for b in range(lidx.shape[0]))
    nv = int(nvalid.long().clamp(max=Np).sum())
    return (pairs * Np + nv * lidx.shape[1]) * T2.element_size() \
        + 8 * (nv + 2 * lidx.numel() + nvalid.numel())


class Like:
    """A tensor's shape, dtype and element size, without its storage."""

    def __init__(self, t):
        self.shape, self.dtype = tuple(t.shape), t.dtype
        self._element_size = t.element_size()

    def element_size(self):
        return self._element_size


def bound_s(moved, ops, dtype_name):
    """Seconds: the larger of the bytes moved over the memory rate and the
    operations over the peak rate of the dtype."""
    return max(moved / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype_name])


def dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def k2_bound_s(inputs, outputs):
    """K2 ``merge_segments``: its inputs and outputs once; a comparison
    sort's C log2 C comparisons per instance."""
    key1 = inputs[0]
    B, C = key1.shape[-2:] if key1.dim() == 2 else (1, key1.shape[0])
    ops = B * C * max(1, (C - 1).bit_length())
    return bound_s(nbytes(*inputs, *outputs), ops, dtype_name(inputs[2]))

