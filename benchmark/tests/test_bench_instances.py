"""The frozen instance generator: deterministic per (seed, k), with the
edges of chimera C(n) and couplings in the droplet class."""

import numpy as np
import pytest

from benchmark.harness import instances
from benchmark.reference import energy


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5])
def test_deterministic_per_seed_and_instance(seed):
    a = instances.make_pool(4, seed, 3)
    b = instances.make_pool(4, seed, 3)
    assert a == b
    assert a[0] != a[1] != a[2]
    assert instances.make_pool(4, seed + 1, 1)[0] != a[0]
    assert instances.make_pool(4, seed, 1, stream=1)[0] != a[0]


@pytest.mark.parametrize("n", [1, 2, 8, 16])
def test_chimera_edges_and_couplings(n):
    c = instances.chimera_couplings(n, instances.instance_rng(3, 0))
    # 16 edges in each cell, 4 to each cell below and to the right
    assert len(c) == 16 * n * n + 8 * n * (n - 1)
    assert len({(i, j) for i, j, _ in c}) == len(c)
    v = np.array([x for _, _, x in c])
    assert np.all(np.abs(v) >= 1 / 75 - 1e-12) and np.all(np.abs(v) <= 1)
    assert np.allclose(v * 75, np.round(v * 75))
    for i, j, _ in c:
        ci, cj = i // 8, j // 8
        assert i < j and (ci == cj or cj == ci + 1 or cj == ci + n)


def test_file_rows_round_trip():
    c = instances.chimera_couplings(2, instances.instance_rng(1, 0))
    rows = instances.droplet_file_rows(c)
    got = energy.couplings(rows)
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in c]
    assert np.allclose([v for *_, v in got], [v for *_, v in c],
                       rtol=0, atol=1e-15)
