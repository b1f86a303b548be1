"""What the port's tests share: one thread policy for every process that
runs them, and the helpers that more than one test module uses.

Every tests/test_torch_*.py imports this module, so the policy holds in
every pytest worker (each collects every module before it runs a case)
and in every spawned mesh rank (a rank imports its test module by name).
This module imports neither jax nor tnax at module level: the card's
machine has no jax, and tests/test_torch_gpu.py runs there without
tests/conftest.py. The helpers that replay tnax import it when called.
"""

import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import tnax_torch as tt

# One thread for torch's intra-op pool and one for NumPy's and SciPy's BLAS,
# for the rest of the process. The tests' operations are tiny, and the suite
# runs 6 xdist workers on 8 cores, where the threads of both pools spin
# against each other. Measured on an 8-core host with test_torch_sample.py's
# two fleet cases: 11.5 s for one copy alone; six copies at once, none done
# within 100 s with the default pools or with either pool capped alone, and
# 28.5-29.9 s each with both at one thread. The BLAS limit covers the
# libraries loaded when it is set: numpy's, and scipy's through tnax_torch.
torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:     # without threadpoolctl only torch's pool is capped
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


# ---------------------------------------------------------------------------
# tnax's random draws, replayed for the port
# ---------------------------------------------------------------------------

def tnax_omega(L, n, k):
    """The sketch matrices tnax's zip-up draws (bmps.py:600, :649)."""
    import jax
    import jax.numpy as jnp
    keys = jax.random.split(jax.random.PRNGKey(0), L)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.normal(keys[i], (n, k), jnp.float64))
        for i in range(L)]))


def tnax_uniforms(key, n_sites, M):
    """The uniforms tnax's sampling pass draws from ``key``: per site in
    row-major order ``key, sub = split(key)``, then ``uniform(sub, (M,))``
    (parallel.py:1296-1297). Returns (n_sites, M) float64."""
    import jax
    import jax.numpy as jnp
    out = []
    for _ in range(n_sites):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (M,), jnp.float64)))
    return np.stack(out)


def dense(A, lognorm):
    """Dense vector of a stacked MPS with boundary bond index 0."""
    A = np.asarray(A)
    D = A.shape[3]
    v = A[0][0]                                   # (d, D)
    for n in range(1, A.shape[0]):
        v = np.einsum("xa,adb->xdb", v, A[n]).reshape(-1, D)
    return v[:, 0] * 2.0 ** float(np.asarray(lognorm))


# ---------------------------------------------------------------------------
# Instances
# ---------------------------------------------------------------------------

def droplet_J(n=2, seed=5):
    """A chimera C(n) droplet-class instance (couplings k/75, random
    signs, no fields): chimera-128 from the committed file, else drawn
    from ``seed``."""
    if n == 4:
        rows = tt.load_Jij(os.path.join(DATA, "chimera128_synth_s0.txt"))
    else:
        rng, rows = np.random.default_rng(seed), []
        for ny in range(n):
            for nx in range(n):
                b = 8 * (n * ny + nx) + 1          # 1-based, as in a file
                pairs = [(b + a, b + c) for a in range(4)
                         for c in range(4, 8)]
                if ny + 1 < n:
                    pairs += [(b + k, b + 8 * n + k) for k in range(4)]
                if nx + 1 < n:
                    pairs += [(b + k, b + 8 + k) for k in range(4, 8)]
                rows += [[i, j, rng.choice([-1, 1]) * rng.integers(1, 76)
                          / 75] for i, j in pairs]
    return tt.round_Jij(tt.Jij_f2p(rows), 1 / 75)


def degenerate_J():
    """A field-free 3x3 lattice of 2+2-spin cells with integer couplings,
    so that its low levels are degenerate."""
    import tnax
    from test_search_small import make_chimera_like
    J = make_chimera_like(np.random.default_rng(4), 3, 3, 2, field=False)
    return [j for j in tnax.round_Jij(J, 1.0) if j[2] != 0]


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------

def badly_scaled(rng, n):
    A = rng.standard_normal((n, n))
    return A * np.exp2(rng.integers(-20, 20, size=(n, 1)))


def extreme_gebal(rng, n, count=4):
    """Badly balanced n x n matrices for K1: a similarity scaling
    2^(k_i - k_j), k in [-25, 25], so that the entries span 2^-50 ..
    2^50, with row 2 and column 5 zero; nd = n, n, n - 3, n // 2."""
    As = []
    for _ in range(count):
        k = rng.integers(-25, 26, size=n)
        A = rng.standard_normal((n, n)) * np.exp2(k[:, None] - k[None, :])
        A[2, :] = 0.0
        A[:, 5] = 0.0
        As.append(A)
    return np.stack(As), np.array([n, n, n - 3, n // 2][:count])


def candidate_set(rng, M, C, Nx, bits):
    """A merge candidate set with repeated vind rows, energy ties within
    min_dEng and exact probability ties; int64 degeneracies."""
    parents = rng.integers(0, 1 << bits, size=(M // 4, Nx + 1))
    vind = parents[rng.integers(0, M // 4, size=C)].astype(np.int32)
    Eng = rng.integers(-40, 40, size=C) / 4.0
    prob = -rng.integers(0, 30, size=C) / 8.0
    valid = rng.random(C) < 0.85
    deg = rng.integers(1, 1 << 24, size=C)
    return vind, Eng, prob, valid, deg


def candidate_key1(vind, valid):
    """An injective int32 key of (vind row, validity): the row's rank."""
    _, rank = np.unique(vind, axis=0, return_inverse=True)
    return ((rank.reshape(-1).astype(np.int32) << 1)
            | (~valid).astype(np.int32))


def marginal_inputs(rng, M=48, Np=16, lh=4, lv=4, D=6, nvalid=13):
    lB = -np.abs(rng.standard_normal((Np, lh, lv))) * 30
    lB[nvalid:] = -np.inf
    lB[:, 3, :] = -np.inf          # a leg value with no allowed state
    drindex = rng.permutation(lh * lv)[:Np].astype(np.int32)
    AT = rng.standard_normal((D, lv, D))
    RL = rng.standard_normal((M, D))
    RRsel = np.abs(rng.standard_normal((M, D, lh)))
    RRsel[::5] -= 0.3              # negative marginals to clamp
    lidx = rng.integers(0, lh, size=M).astype(np.int32)
    uidx = rng.integers(0, lv, size=M).astype(np.int32)
    return lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid


# ---------------------------------------------------------------------------
# Mesh ranks
# ---------------------------------------------------------------------------

def spawn(fn, world, args, timeout=240):
    """Run fn(rank, *args) in ``world`` spawned processes; raise if any
    rank raises or the ranks outlast ``timeout`` seconds."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.time() + timeout
    while not ctx.join(timeout=1.0):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"mesh ranks still running after {timeout} s")
