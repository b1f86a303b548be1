"""Port parity of the Solver's Gibbs sampling against tnax's, in float64
on the CPU, on both of tnax's paths: the context functions
(``device_sample``, ``multi_sample``) with tnax's jax.random streams
replayed and injected as uniforms, and the host path with its NumPy
generator, drawn in tnax's order. tnax's sketch matrices are handed to
the port's zip-up. Inputs are made with numpy from seeds."""

import jax
import numpy as np
import pytest

import tnax
from tnax import parallel as jpar
import tnax_torch as tt
from tnax_torch import parallel
from test_search_small import make_chimera_like
from torch_helpers import tnax_omega, tnax_uniforms

NX = NY = 3
NC = 4
M = 48
BETA = 0.5     # low enough for the walkers to spread over many states
KW = dict(M=M, Dmax=8)


@pytest.fixture(autouse=True)
def _tnax_sketch(monkeypatch):
    # tnax's sampling boundary reads the ambient zip-up default
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")


def _pair(seed, rot=0):
    J = make_chimera_like(np.random.default_rng(seed), NX, NY, NC)
    pair = (tnax.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=BETA, J=J),
            tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=BETA, J=J,
                      device="cpu"))
    for s in pair:
        s.rotate_graph(rot=rot)
    return J, pair


def _assert_same(got, want, J, ins):
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    np.testing.assert_allclose(got["energy"], np.asarray(want["energy"]),
                               rtol=0, atol=1e-9)
    assert got["negative_probability"] == pytest.approx(
        float(want["negative_probability"]), abs=1e-10)
    ins.states = got["states"][:, ins.order]
    np.testing.assert_allclose(got["energy"],
                               tt.energy_Jij(J, ins.binary_states()),
                               rtol=0, atol=1e-9)


def test_device_sample_matches_tnax_stream():
    """tnax splits PRNGKey(seed) site by site, rows then columns."""
    J, (ins_j, ins) = _pair(17, rot=1)
    want = jpar.device_sample(ins_j._context(), seed=3, **KW)
    u = tnax_uniforms(jax.random.PRNGKey(3), NY * NX, M)
    got = parallel.device_sample(ins._context(), omega=tnax_omega,
                                 uniforms=u.reshape(NY, NX, M), **KW)
    _assert_same(got, want, J, ins)
    assert len({tuple(s) for s in got["states"]}) > M // 2


def test_multi_sample_matches_tnax_streams():
    """tnax folds the instance index into PRNGKey(seed)."""
    pairs = [_pair(s) for s in (18, 19, 20)]
    want = jpar.multi_sample([p[1][0]._context() for p in pairs], seed=5,
                             **KW)
    u = np.stack([tnax_uniforms(jax.random.fold_in(jax.random.PRNGKey(5), b),
                                NY * NX, M).reshape(NY, NX, M)
                  for b in range(3)])
    got = parallel.multi_sample([p[1][1]._context() for p in pairs],
                                omega=tnax_omega, uniforms=u, **KW)
    assert len(got) == len(want) == 3
    for g, w, (J, (_, ins)) in zip(got, want, pairs):
        _assert_same(g, w, J, ins)


def _first_mismatches(got, want, order_i):
    """(walker, snake-order site) of each walker's first differing block
    state; ``got``/``want`` are a Solver's states in cluster order."""
    a, b = got[:, order_i], want[:, order_i]
    out = []
    for w in np.flatnonzero((a != b).any(axis=1)):
        out.append((w, int(np.flatnonzero(a[w] != b[w])[0])))
    return out


@pytest.mark.parametrize("rot,seed", [(0, 4), (3, 8)])
def test_host_sampling_matches_tnax(rot, seed):
    """The host path with ``seed`` gives tnax's samples. A walker may
    differ only where its uniform lies within 1e-12 of a boundary of the
    cumulative distribution at the first site where it differs: moving
    that uniform by 1e-12 then gives tnax's draw there."""
    J, (ins_j, ins) = _pair(21, rot=rot)
    ins_j.gibbs_sampling(seed=seed, **KW)
    ins.gibbs_sampling(seed=seed, omega=tnax_omega, **KW)
    np.testing.assert_allclose(ins.energy,
                               tt.energy_Jij(J, ins.binary_states()),
                               rtol=0, atol=1e-9)
    assert ins.negative_probability == pytest.approx(
        ins_j.negative_probability, abs=1e-10)
    assert len({tuple(s) for s in ins.states}) > M // 2
    rng = np.random.default_rng(seed)
    u = np.stack([rng.random(M) for _ in range(NY * NX)])
    for w, site in _first_mismatches(ins.states, ins_j.states, ins.order_i):
        explained = False
        for step in (-1e-12, 1e-12):
            v = u.copy()
            v[site, w] += step
            r = parallel.device_sample(ins._context(), omega=tnax_omega,
                                       uniforms=v.reshape(NY, NX, M), **KW)
            explained |= r["states"][w, site] == \
                ins_j.states[w, ins.order_i][site]
        assert explained, (w, site)
    same = (ins.states == ins_j.states).all(axis=1)
    assert same.sum() >= M - 2
    np.testing.assert_allclose(ins.energy[same], ins_j.energy[same],
                               rtol=0, atol=1e-9)


def test_host_sampling_draws_numpy_in_tnax_order():
    """The host path's uniforms are ``rng.random(M)`` per site, rows then
    columns, from ``default_rng(seed)``: ``device_sample`` on those
    uniforms gives the same samples, and another seed other ones."""
    _, (_, ins) = _pair(22)
    ins.gibbs_sampling(seed=6, omega=tnax_omega, **KW)
    rng = np.random.default_rng(6)
    u = np.stack([rng.random(M) for _ in range(NY * NX)])
    r = parallel.device_sample(ins._context(), omega=tnax_omega,
                               uniforms=u.reshape(NY, NX, M), **KW)
    assert np.array_equal(ins.states, r["states"][:, ins.order])
    np.testing.assert_array_equal(ins.energy, r["energy"])
    first = ins.states.copy()
    ins.gibbs_sampling(seed=7, omega=tnax_omega, **KW)
    assert not np.array_equal(first, ins.states)


def test_device_path_seed_is_the_fleet_stream():
    """``path="device"`` draws from ``seed or 0`` on the device: the
    stream of instance 0 of a fleet (``parallel.instance_uniforms``), as
    the flagship sampler does."""
    _, (_, ins) = _pair(23)
    ins.gibbs_sampling(path="device", omega=tnax_omega, **KW)
    r0 = parallel.device_sample(ins._context(), seed=0, omega=tnax_omega,
                                **KW)
    assert np.array_equal(ins.states, r0["states"][:, ins.order])
    assert ins.degeneracy == 0 and ins.discarded_probability == 0
    ins.gibbs_sampling(path="device", seed=2, omega=tnax_omega, **KW)
    r2 = parallel.multi_sample([ins._context()], seed=2, omega=tnax_omega,
                               **KW)[0]
    assert np.array_equal(ins.states, r2["states"][:, ins.order])


def test_solver_sampling_is_the_flagship_sampler():
    """precondition + gibbs_sampling(path="device") under the flagship's
    ladder (one rung, tolS 1e-15) gives the flagship sampler's walkers
    on the same seed: one sampling body."""
    _, (_, ins) = _pair(24)
    want = parallel.flagship_sample(ins, seed=9, omega=tnax_omega, **KW)
    ins.precondition(steps=1, tolS=1e-15, path="device", omega=tnax_omega)
    ins.gibbs_sampling(path="device", seed=9, omega=tnax_omega, **KW)
    assert np.array_equal(ins.states[:, ins.order_i], want["states"])
    np.testing.assert_array_equal(ins.energy, want["energy"])
