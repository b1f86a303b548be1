"""Port parity of Gibbs sampling against tnax, in float64 on the CPU: the
per-site draw (the plain version of kernel K4), one sampling row, and the
whole sampler for one instance and for a fleet, with tnax's own uniforms
(replayed with jax.random) and tnax's sketch matrices handed to the
port; the fleet against the port's single runs; the port's own generator
against the exact Boltzmann distribution of a brute-forced lattice.
Inputs are made with numpy from seeds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import engine as jengine
from tnax import parallel as jpar
import tnax_torch as tt
from tnax_torch import engine, kernels, parallel
from test_search_small import brute_force_min, make_chimera_like
from torch_helpers import marginal_inputs, tnax_omega, tnax_uniforms

NX = NY = 3
NC = 4
M = 48
BETA = 0.5     # low enough for the walkers to spread over many states
KW = dict(M=M, Dmax=8, pre_steps=2, zipup_rsvd=True)


def _Js(seeds=(17, 18, 19)):
    return [make_chimera_like(np.random.default_rng(s), NX, NY, NC)
            for s in seeds]


def _solver(J, **kw):
    return tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=BETA, J=J,
                     device="cpu", **kw)


def _tnax_solver(J):
    return tnax.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=BETA, J=J)


def _assert_same_samples(got, want, J, ins):
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    np.testing.assert_allclose(got["energy"], np.asarray(want["energy"]),
                               rtol=0, atol=1e-9)
    assert got["negative_probability"] == pytest.approx(
        float(want["negative_probability"]), abs=1e-10)
    # and every energy is that of its decoded state
    ins.states = got["states"][:, ins.order]
    np.testing.assert_allclose(got["energy"],
                               tt.energy_Jij(J, ins.binary_states()),
                               rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def fleets(monkeypatch_module):
    """tnax's fleet sampler and the port's on the same three instances,
    with tnax's uniforms (fold_in streams) injected into the port."""
    Js = _Js()
    want = jpar.multi_flagship_sample([_tnax_solver(J) for J in Js], seed=5,
                                      **KW)
    u = np.stack([tnax_uniforms(jax.random.fold_in(jax.random.PRNGKey(5), b),
                                NY * NX, M).reshape(NY, NX, M)
                  for b in range(len(Js))])
    solvers = [_solver(J) for J in Js]
    got = parallel.multi_flagship_sample(solvers, omega=tnax_omega,
                                         uniforms=u, **KW)
    return Js, solvers, u, want, got


@pytest.fixture(scope="module")
def monkeypatch_module():
    # tnax's flagship ladder reads the ambient sketch default; the port's
    # ladder always sketches
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TNAX_ZIPUP_RSVD", "1")
        yield mp


def test_flagship_sample_matches_tnax(monkeypatch_module):
    J = _Js((23,))[0]
    want = jpar.flagship_sample(_tnax_solver(J), seed=3, **KW)
    u = tnax_uniforms(jax.random.PRNGKey(3), NY * NX, M).reshape(NY, NX, M)
    ins = _solver(J)
    got = parallel.flagship_sample(ins, omega=tnax_omega, uniforms=u, **KW)
    _assert_same_samples(got, want, J, ins)
    # the walkers spread over many states
    assert len({tuple(s) for s in got["states"]}) > M // 2


def test_fleet_sample_matches_tnax_fleet(fleets):
    Js, solvers, _, want, got = fleets
    assert len(got) == len(want) == 3
    for J, ins, g, w in zip(Js, solvers, got, want):
        _assert_same_samples(g, w, J, ins)


def test_fleet_sample_instances_match_single_runs(fleets):
    Js, _, u, _, got = fleets
    for J, u_b, g in zip(Js, u, got):
        one = parallel.flagship_sample(_solver(J), omega=tnax_omega,
                                       uniforms=u_b, **KW)
        assert np.array_equal(g["states"], one["states"])
        np.testing.assert_array_equal(g["energy"], one["energy"])
        assert g["negative_probability"] == pytest.approx(
            one["negative_probability"], abs=1e-12)


def test_instance_streams_do_not_depend_on_the_fleet():
    """Instance b's uniforms come from (seed, b) alone: a fleet of three
    and a fleet of its first two agree on those two, and the single
    sampler is stream b = 0."""
    Js = _Js((17, 18, 19))
    kw = dict(KW, M=16, seed=9)
    three = parallel.multi_flagship_sample([_solver(J) for J in Js], **kw)
    two = parallel.multi_flagship_sample([_solver(J) for J in Js[:2]], **kw)
    one = parallel.flagship_sample(_solver(Js[0]), **kw)
    for a, b in zip(three[:2], two):
        assert np.array_equal(a["states"], b["states"])
    assert np.array_equal(one["states"], three[0]["states"])
    u = [parallel.instance_uniforms(9, b, (4, 16), torch.float64, "cpu")
         for b in range(2)]
    assert not torch.equal(u[0], u[1])
    assert bool(((u[0] >= 0) & (u[0] < 1)).all())


def test_sample_rows_matches_tnax():
    """One sampling row of random tensors through both packages; the
    port's row is a batch of one instance."""
    rng = np.random.default_rng(31)
    Nx, Np, lh, lv, D, Mw = 3, 16, 4, 4, 6, 40
    sites = [marginal_inputs(rng, M=Mw, Np=Np, lh=lh, lv=lv, D=D,
                             nvalid=nv) for nv in (13, 16, 9)]
    lB = np.stack([s[0] for s in sites])
    drindex = np.stack([s[1] for s in sites])
    AT = np.stack([s[2] for s in sites])
    RRs = np.stack([s[4] for s in sites])
    nvalid = np.array([s[7] for s in sites], np.int32)
    dmap = rng.integers(0, lv, size=(Nx, Np)).astype(np.int32)
    rmap = rng.integers(0, lh, size=(Nx, Np)).astype(np.int32)
    cols = np.array([3, 4, 5], np.int32)
    RL = rng.standard_normal((Mw, D))
    vind = np.concatenate([rng.integers(0, lh, size=(Mw, 1)),
                           rng.integers(0, lv, size=(Mw, Nx))],
                          axis=1).astype(np.int32)
    states = rng.integers(0, Np, size=(Mw, 9)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    row = dict(lB=lB, drindex=drindex, AT=AT, RRs=RRs, dmap=dmap, rmap=rmap,
               nvalid=nvalid, cols=cols)
    want, _, mq_want = jpar.sample_rows(
        dict(RL=jnp.asarray(RL), vind=jnp.asarray(vind),
             states=jnp.asarray(states)),
        {k: jnp.asarray(v) for k, v in row.items()}, key, M=Mw, Nx=Nx)
    u = tnax_uniforms(key, Nx, Mw)
    rowt = {k: torch.as_tensor(v)[None] for k, v in row.items()
            if k not in ("cols", "lB")}
    rowt["lBT"] = kernels.marginal.boltzmann_columns(torch.as_tensor(lB)[None])
    rowt["cols"] = cols.tolist()
    beam = dict(RL=torch.as_tensor(RL)[None], vind=torch.as_tensor(vind)[None],
                states=torch.as_tensor(states)[None])
    got, mq = parallel.sample_rows(beam, rowt, torch.as_tensor(u)[None],
                                   M=Mw, Nx=Nx)
    for k in ("vind", "states"):
        assert np.array_equal(got[k][0].numpy(), np.asarray(want[k])), k
    np.testing.assert_allclose(got["RL"][0].numpy(), np.asarray(want["RL"]),
                               rtol=1e-10, atol=1e-13)
    assert float(mq[0]) == pytest.approx(float(mq_want), rel=1e-10,
                                         abs=1e-14)
    # the input beam is left as it was
    assert np.array_equal(beam["vind"][0].numpy(), vind)


def _tnax_draw(lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid, u):
    """tnax's inline draw: marginal_step, then parallel.py:1295-1299."""
    Pn, mPn = jengine.marginal_step(*(jnp.asarray(a) for a in (
        lB, drindex, AT, RL, RRsel, lidx, uidx)), nvalid)
    cums = jnp.cumsum(Pn, axis=1)
    indc = jnp.clip(jnp.sum(cums < jnp.asarray(u)[:, None], axis=1), 0,
                    nvalid - 1).astype(jnp.int32)
    return np.asarray(indc), np.asarray(mPn)


@pytest.mark.parametrize("case", ["valid", "full", "zero_rows"])
def test_sample_draw_plain_matches_tnax(case):
    """Three instances in one batch through K4's wrapper on CPU tensors (its
    plain version), each draw against tnax's: some states past nvalid, all
    states valid, and rows whose marginals are all zero (the uniform row);
    uniforms include 0 and the largest float below 1."""
    rng = np.random.default_rng(dict(valid=40, full=41, zero_rows=42)[case])
    nvs = dict(valid=(13, 9, 1), full=(16, 16, 16),
               zero_rows=(13, 16, 7))[case]
    ins = [marginal_inputs(rng, M=48, nvalid=nv) for nv in nvs]
    if case == "zero_rows":
        for a in ins:
            a[4][::3] = 0.0        # RRsel rows of zeros: T2 rows of zeros
    u = rng.random((3, 48))
    u[:, 0], u[:, 1] = 0.0, np.nextafter(1.0, 0.0)
    lB, drindex, AT, RL, RRsel, lidx, uidx = (
        torch.as_tensor(np.stack(x)) for x in list(zip(*ins))[:7])
    T2 = engine._marginal_T2(AT, RL, RRsel)
    nx, col = 1, 2
    vind = torch.zeros((3, 48, 4), dtype=torch.int32)
    vind[:, :, nx], vind[:, :, nx + 1] = lidx, uidx
    states = torch.zeros((3, 48, 5), dtype=torch.int32)
    dmap = torch.as_tensor(rng.integers(0, 4, size=(3, 16)), dtype=torch.int32)
    mq = torch.full((3,), np.inf, dtype=torch.float64)
    before = kernels.sample_site.launches
    _, mPn = kernels.sample_site(
        T2, kernels.marginal.boltzmann_columns(lB), drindex.long(), dmap,
        dmap.flip(1), torch.tensor(nvs), torch.as_tensor(u), AT, RL, vind,
        states, nx, col, mq)
    for b in range(3):
        indc, mPn_t = _tnax_draw(*ins[b][:7], nvs[b], u[b])
        assert np.array_equal(states[b, :, col].numpy(), indc), b
        np.testing.assert_allclose(mPn[b].numpy(), mPn_t, rtol=1e-12,
                                   atol=1e-15)
        assert states[b, :, col].max() <= nvs[b] - 1
    assert torch.equal(mq, mPn.amin(dim=1))
    if case == "zero_rows":
        assert bool((mPn[:, ::3] == -1.0).all())
    assert kernels.sample_site.launches == before


def test_draw_mismatches_explains_only_boundary_draws():
    """The kernel check's rule: a draw that differs from the plain
    version's is explained only where the cumulative sums between the two
    indices lie within 64 eps of the uniform."""
    T2 = torch.ones((1, 2, 4), dtype=torch.float64)
    lBT = torch.zeros((1, 2, 2, 4), dtype=torch.float64)
    idx = torch.zeros((1, 2), dtype=torch.int64)
    u = torch.tensor([[0.5 + 1e-16, 0.3]], dtype=torch.float64)
    args = (T2, lBT, torch.arange(4)[None], idx, idx, torch.tensor([4]), u)
    want, _ = kernels.sample_draw_plain(*args)
    assert want.tolist() == [[2, 1]]
    # walker 0's u sits on the boundary cums[1] = 0.5; walker 1's does not
    assert kernels.sample.draw_mismatches(
        torch.tensor([[1, 1]], dtype=torch.int32), want, args) == (1, 0)
    assert kernels.sample.draw_mismatches(
        torch.tensor([[2, 2]], dtype=torch.int32), want, args) == (1, 1)
    assert kernels.sample.draw_mismatches(want, want, args) == (0, 0)


def test_sample_distribution_matches_boltzmann():
    """The port's own generator, M=4000 walkers of a brute-forced 2x1
    lattice of 2-spin blocks: each energy's frequency within 0.05 of its
    Boltzmann weight."""
    rng = np.random.default_rng(12)
    J = make_chimera_like(rng, 2, 1, 2)
    ins = tt.Solver(mode="Ising", Nx=2, Ny=1, Nc=2, beta=1, J=J,
                    device="cpu")
    res = parallel.flagship_sample(ins, M=4000, Dmax=8, seed=3)
    ins.states = res["states"][:, ins.order]
    np.testing.assert_allclose(res["energy"],
                               tt.energy_Jij(J, ins.binary_states()),
                               atol=1e-9)
    _, Eall = brute_force_min(J, 4)
    p = np.exp(-(Eall - Eall.min()))
    p /= p.sum()
    theo = {}
    for e, pi in zip(np.round(Eall, 9), p):
        theo[e] = theo.get(e, 0.0) + pi
    vals, counts = np.unique(np.round(res["energy"], 9), return_counts=True)
    assert len(vals) > 3
    for v, c in zip(vals, counts):
        assert abs(c / 4000 - theo[v]) < 0.05, v


def test_one_row_lattice_search_matches_tnax():
    """A lattice of one row has no interface for the balancing ladder
    to balance; tnax's vmap over none leaves the gauges as they are, and
    so does the port."""
    J = make_chimera_like(np.random.default_rng(12), 2, 1, 2)
    want = jpar.flagship_search_gs(
        tnax.Solver(mode="Ising", Nx=2, Ny=1, Nc=2, beta=1, J=J), M=16,
        Dmax=8)
    ins = tt.Solver(mode="Ising", Nx=2, Ny=1, Nc=2, beta=1, J=J,
                    device="cpu")
    got = parallel.flagship_search_gs(ins, M=16, Dmax=8)
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    assert got["degeneracy"] == want["degeneracy"]
    assert got["energy"] == pytest.approx(brute_force_min(J, 4)[0],
                                          abs=1e-9)


@pytest.mark.parametrize("what", ["shape", "beta", "dtype", "uniforms"])
def test_sample_refuses_mixed_instances(what):
    J, J2 = _Js((1, 2))
    kw = dict(KW, M=8)
    if what == "uniforms":
        with pytest.raises(ValueError, match="uniforms"):
            parallel.multi_flagship_sample(
                [_solver(J), _solver(J2)], uniforms=np.zeros((2, NY, NX, 9)),
                **kw)
        return
    other = dict(
        shape=lambda: tt.Solver(mode="Ising", Nx=NX + 1, Ny=NY, Nc=NC,
                                beta=BETA, device="cpu",
                                J=make_chimera_like(
                                    np.random.default_rng(3), NX + 1, NY,
                                    NC)),
        beta=lambda: tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=3,
                               J=J2, device="cpu"),
        dtype=lambda: _solver(J2, dtype=torch.float32))[what]()
    match = dict(shape="Ny, Nx", beta="beta", dtype="dtype")[what]
    with pytest.raises(ValueError, match=match):
        parallel.multi_flagship_sample([_solver(J), other], **kw)


def test_sampler_needs_a_device_by_default(monkeypatch):
    """The sampler runs on CUDA unless given the CPU: without a card the
    solver it takes cannot be made, and the draw refuses other devices."""
    J = _Js((4,))[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.flagship_sample(tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC,
                                     beta=BETA, J=J), M=8)
    meta = torch.zeros((1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.sample_site(meta, *(None,) * 13)
