"""The port's fleet (one batch axis through the ladder, the boundary MPS
and the beam search) against tnax's vmapped fleet and against the port's
own single-instance runs, in float64 on the CPU; the masked sweep loop,
the batched boundary lanes and the batched plain versions of K2 and K3
against per-instance calls; and the device default of the entry points.
Inputs are made with numpy from seeds."""

import numpy as np
import pytest
import torch

import tnax
from tnax import parallel as jpar
import tnax_torch as tt
from tnax_torch import bmps, engine, kernels, parallel
from test_search_small import make_chimera_like
from torch_helpers import (candidate_key1, candidate_set, marginal_inputs,
                           tnax_omega)

NX = NY = 3
NC = 4
KW = dict(M=64, relative_P_cutoff=1e-10, Dmax=8, zipup_rsvd=True)


def _Js(seeds=(17, 18, 19)):
    return [make_chimera_like(np.random.default_rng(s), NX, NY, NC)
            for s in seeds]


def _solver(J, **kw):
    return tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=2, J=J,
                     device="cpu", **kw)


def _recheck(J, ins, states):
    ins.states = np.asarray(states)[None, :][:, ins.order]
    return float(tt.energy_Jij(J, ins.binary_states())[0])


@pytest.fixture(scope="module")
def fleets():
    """tnax's fleet and the port's fleet on the same three instances, with
    tnax's sketch matrices handed to the port."""
    Js = _Js()
    with pytest.MonkeyPatch.context() as mp:
        # tnax's flagship ladder reads the ambient sketch default; the
        # port's ladder always sketches
        mp.setenv("TNAX_ZIPUP_RSVD", "1")
        want = jpar.multi_flagship_search_gs(
            [tnax.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=2, J=J)
             for J in Js], **KW)
    solvers = [_solver(J) for J in Js]
    got = tt.parallel.multi_flagship_search_gs(solvers, omega=tnax_omega,
                                               **KW)
    return Js, solvers, want, got


def test_fleet_matches_tnax_fleet(fleets):
    Js, solvers, want, got = fleets
    assert len(got) == len(want) == 3
    for J, ins, g, w in zip(Js, solvers, got, want):
        assert np.array_equal(g["states"], np.asarray(w["states"]))
        for k in ("degeneracy", "merge_overflow", "count_max"):
            assert g[k] == w[k], k
        # tnax's fleet returns f32-rounded energies: compare rechecks
        E = _recheck(J, ins, g["states"])
        assert E == pytest.approx(_recheck(J, ins, w["states"]), abs=1e-9)
        assert g["energy"] == pytest.approx(E, abs=1e-9)
        assert g["discarded_probability"] == pytest.approx(
            w["discarded_probability"], rel=1e-6)
    # the instances differ, so a lane leaking into another would show
    assert len({tuple(g["states"]) for g in got}) == 3


def test_fleet_instances_match_single_runs(fleets):
    Js, solvers, _, got = fleets
    for J, g in zip(Js, got):
        one = tt.parallel.flagship_search_gs(_solver(J), omega=tnax_omega,
                                             **KW)
        assert np.array_equal(g["states"], one["states"])
        assert g["degeneracy"] == one["degeneracy"]
        assert g["energy"] == pytest.approx(one["energy"], abs=1e-9)


@pytest.mark.parametrize("what", ["shape", "beta", "dtype"])
def test_fleet_refuses_mixed_instances(what):
    J, J2 = _Js((1, 2))
    other = dict(
        shape=lambda: tt.Solver(mode="Ising", Nx=NX + 1, Ny=NY, Nc=NC,
                                beta=2, device="cpu",
                                J=make_chimera_like(
                                    np.random.default_rng(3), NX + 1, NY,
                                    NC)),
        beta=lambda: tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=3,
                               J=J2, device="cpu"),
        dtype=lambda: _solver(J2, dtype=torch.float32))[what]()
    with pytest.raises(ValueError):
        tt.parallel.multi_flagship_search_gs([_solver(J), other], **KW)


# ---------------------------------------------------------------------------
# the masked sweep loop
# ---------------------------------------------------------------------------

def _lane(seed, kind, L=4, D=4, d=4, lh=3):
    """A random MPS and MPO row. "product": a product MPO, so the target
    fits the bond and the sweeps stop after two; "weak": the MPO's bond
    channels damped by 1e-2; "random": no structure."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((L, D, d, D))
    W = rng.standard_normal((L, lh, d, lh, d))
    if kind == "product":
        W[:, 1:] = 0
        W[:, :, :, 1:] = 0
    elif kind == "weak":
        W[:, :, :, 1:] *= 1e-2
    return A, W


# (lanes, sweep counts of the lanes run alone): f64 stops by tolerance
# (2, 3) or by max_sweeps (6); f32 adds the plateau rule (3 of 6)
SWEEP_CASES = {
    "float64": ([(0, "product"), (1, "weak"), (0, "random")], [2, 3, 6]),
    "float32": ([(0, "random"), (0, "product"), (1, "random")], [3, 2, 6]),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_masked_sweeps_match_unbatched(dtype):
    lanes, counts = SWEEP_CASES[dtype]
    dt = getattr(torch, dtype)
    A, W = (torch.as_tensor(np.stack(x), dtype=dt)
            for x in zip(*(_lane(*ln) for ln in lanes)))
    kw = dict(conj=True, tolS=1e-16, tolV=1e-10, max_sweeps=6, rsvd=False)
    out, ov, disc, sweeps = bmps.compress_apply(
        bmps.MPS(A, torch.zeros(3, dtype=dt)), W, 4, **kw)
    assert sweeps.tolist() == counts
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    for b in range(3):
        o1, ov1, d1, s1 = bmps.compress_apply(
            bmps.MPS(A[b:b + 1], torch.zeros(1, dtype=dt)), W[b:b + 1], 4,
            **kw)
        assert int(s1[0]) == counts[b]
        for x, y in ((out.A[b], o1.A[0]), (out.lognorm[b], o1.lognorm[0]),
                     (ov[b], ov1[0]), (disc[b], d1[0])):
            torch.testing.assert_close(x, y, rtol=rtol, atol=rtol * 1e-2)


def test_build_rho_both_batched_matches_per_instance_stacks():
    """The 2B-lane boundary build of three instances against build_rhoT
    of each instance's rows and of their mirror."""
    tabs = []
    for J in _Js():
        g = engine.pad_grid(_solver(J).problem)
        X = engine.identity_gauges(g)
        tabs.append([g.Es, g.Esl, g.Esu, g.dmap, g.rmap, X["Xl"], X["Xr"],
                     X["Xu"], X["Xd"]])
    args = [torch.as_tensor(np.stack(a)) for a in zip(*tabs)]
    _, Wt = engine.peps_rows(*args, 1.0, lh=g.lh, lv=g.lv)
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-10, max_sweeps=20, rsvd=False)
    rhoT, rhoB = engine.build_rho_both(Wt, **kw)
    for b in range(3):
        one = Wt[b:b + 1]
        mirror = torch.flip(one.permute(0, 1, 2, 3, 6, 5, 4), dims=(1,))
        torch.testing.assert_close(rhoT[b], engine.build_rhoT(one, **kw)[0][0],
                                   rtol=1e-12, atol=1e-14)
        rb = engine.build_rhoT(mirror, **kw)[0][0]
        rb = torch.cat([rb[-1:], torch.flip(rb[:-1], dims=(0,))])
        torch.testing.assert_close(rhoB[b], rb, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# K2 and K3 plain versions, batched against per-instance calls
# ---------------------------------------------------------------------------

def test_merge_segments_plain_batched_matches_per_instance():
    rng = np.random.default_rng(5)
    sets = [candidate_set(rng, 64, 512, 4, 3) for _ in range(4)]
    key1 = np.stack([candidate_key1(v, ok) for v, _, _, ok, _ in sets])
    args = [torch.as_tensor(key1)] + [
        torch.as_tensor(np.stack(x)) for x in list(zip(*sets))[1:]]
    got = kernels.merge_segments_plain(*args, 1e-12)
    for b in range(4):
        one = kernels.merge_segments_plain(*(a[b] for a in args), 1e-12)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)
    # and through the wrapper, which takes the plain version on the CPU
    for x, y in zip(kernels.merge_segments(*args, 1e-12), got):
        assert torch.equal(x, y)


def test_marginal_epilogue_plain_batched_matches_per_instance():
    rng = np.random.default_rng(6)
    ins = [marginal_inputs(rng, nvalid=nv) for nv in (13, 16, 9)]
    lB, drindex, AT, RL, RRsel, lidx, uidx = (
        torch.as_tensor(np.stack(x)) for x in list(zip(*ins))[:7])
    nvalid = torch.tensor([a[-1] for a in ins])
    prob = torch.as_tensor(-np.abs(rng.standard_normal((3, 48))) * 40)
    valid = torch.as_tensor(rng.random((3, 48)) < 0.7)
    T2 = engine._marginal_T2(AT, RL, RRsel)
    args = (T2, kernels.marginal.boltzmann_columns(lB), drindex, lidx, uidx,
            nvalid, prob, valid)
    got = kernels.marginal_epilogue(*args, -30.0)
    for b in range(3):
        one = kernels.marginal_epilogue_plain(*(a[b:b + 1] for a in args),
                                              -30.0)
        for x, y in zip(got, one):
            torch.testing.assert_close(x[b], y[0], rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# host helpers and the device default
# ---------------------------------------------------------------------------

def test_exact_energies_problem_matches_tnax():
    J = _Js((4,))[0]
    ins = _solver(J)
    ref = tnax.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=2, J=J)
    states = np.random.default_rng(0).integers(
        0, 2 ** NC, size=(20, NX * NY)).astype(np.int32)
    got = parallel.exact_energies_problem(ins.problem, states)
    assert np.array_equal(got, jpar.exact_energies_problem(ref.problem,
                                                           states))
    ins.states = states[:, ins.order]
    np.testing.assert_allclose(got, tt.energy_Jij(J, ins.binary_states()),
                               rtol=1e-12, atol=1e-12)


def test_solver_defaults_to_cuda(monkeypatch):
    J = _Js((4,))[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.Solver(mode="Ising", Nx=NX, Ny=NY, Nc=NC, beta=2, J=J)
    ins = _solver(J)
    assert (ins.device.type, ins.dtype) == ("cpu", torch.float64)
