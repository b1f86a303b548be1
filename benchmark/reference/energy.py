"""Plain NumPy Ising energies: the yardstick for every returned energy.

Imports neither jax, tnax nor anything of tnax_torch. A droplet-instance
file holds 1-based ``i j Jij`` rows; e01 loads them as
``round_Jij(Jij_f2p(J), 1/75)``, which :func:`couplings` works out again.
The energy of spins s_i = +-1 (bit 1 = up) is the sum of Jij s_i s_j over
the pairs i != j and of Jii s_i over the fields.
"""

from __future__ import annotations

import numpy as np


def couplings(rows, dJ=1 / 75):
    """0-based ``(i, j, Jij)`` with Jij rounded to integer multiples of
    ``dJ``, from 1-based file rows."""
    dJ = float(dJ)
    return [(int(i) - 1, int(j) - 1, round(v / dJ) * dJ) for i, j, v in rows]


def energies(coupl, bits):
    """Energies (S,) of the bit-string states ``bits`` (S, L)."""
    bits = np.atleast_2d(np.asarray(bits))
    s = 2.0 * bits.astype(np.float64) - 1.0
    i, j, v = (np.array(c) for c in zip(*coupl))
    i, j = i.astype(np.int64), j.astype(np.int64)
    field = i == j
    pair = ~field
    return (s[:, i[pair]] * s[:, j[pair]]) @ v[pair] \
        + s[:, i[field]] @ v[field]
