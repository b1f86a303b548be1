"""Seeded chimera C(n) spin-glass instances, the benchmark's traffic.

``chimera_couplings`` is a frozen copy of
``tools/make_chimera_instance.py:chimera_couplings`` (lines 60-80), with
one change: it takes a NumPy generator instead of a seed, so that instance
k of run seed s has a generator of its own (:func:`instance_rng`). The
layout: spin ``m`` of cell (ny, nx) has index ``8 * (n * ny + nx) + m``;
inside a cell every spin k < 4 couples to every spin k' >= 4; spin k < 4
couples to the same k in the cell below, spin k >= 4 to the same k in the
cell to the right. Couplings are nonzero integer multiples of 1/75 in
[-1, 1]: a uniform magnitude in 1..75 and a uniform sign, the class of
tnac4o's ``chimera*_spinglass_power`` droplet instances.
"""

from __future__ import annotations

import numpy as np

SPINS_PER_CELL = 8


def instance_rng(seed: int, k: int, stream: int = 0) -> np.random.Generator:
    """The generator of instance ``k`` of run seed ``seed``; ``stream``
    separates the window's pool (0) from the warm-up instances (1). Any
    whole number is a seed: it enters as its 64-bit two's complement."""
    return np.random.default_rng([seed & (2 ** 64 - 1), k, stream])


def chimera_couplings(n: int, rng: np.random.Generator):
    """[(i, j, Jij)] with 0-based i < j for chimera C(n)."""
    pairs = []
    for ny in range(n):
        for nx in range(n):
            base = 8 * (n * ny + nx)
            for a in range(4):
                for b in range(4, 8):
                    pairs.append((base + a, base + b))
            if ny + 1 < n:
                below = 8 * (n * (ny + 1) + nx)
                for k in range(4):
                    pairs.append((base + k, below + k))
            if nx + 1 < n:
                right = 8 * (n * ny + nx + 1)
                for k in range(4, 8):
                    pairs.append((base + k, right + k))
    mag = rng.integers(1, 76, size=len(pairs))
    sign = rng.choice(np.array([-1, 1]), size=len(pairs))
    return [(i, j, int(s * m) / 75.0)
            for (i, j), s, m in zip(pairs, sign, mag)]


def droplet_file_rows(couplings):
    """The couplings as the rows of a droplet-instance file: 1-based
    ``[i, j, Jij]``, what ``load_Jij`` returns for such a file."""
    return [[i + 1, j + 1, v] for i, j, v in couplings]


def make_pool(n: int, seed: int, count: int, stream: int = 0):
    """``count`` instances of chimera C(n) for run seed ``seed``, each as
    its droplet-file rows."""
    return [droplet_file_rows(chimera_couplings(n, instance_rng(seed, k,
                                                                stream)))
            for k in range(count)]
