"""Port parity of the Solver's ground-state search against tnax's, in
float64 on the CPU, on both of tnax's paths: the host-exact search
(rotations, noise, no cutoff, zero marginals, checkpoints written by
either package, chimera-128), the float32 fast path of its candidate
expansion, and the device search through its context functions
(``device_search_gs``, ``multi_search_gs``) and against the flagship
pipeline under the same ladder. tnax's sketch matrices are handed to the
port's zip-up. Inputs are made with numpy from seeds."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import engine as jengine
from tnax import parallel as jpar
from tnax import search as jsearch
import tnax_torch as tt
from tnax_torch import engine, kernels, parallel, search
from test_search_small import make_chimera_like
from torch_helpers import marginal_inputs, tnax_omega

KW = dict(M=16, relative_P_cutoff=1e-6, Dmax=8)
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def _tnax_sketch(monkeypatch):
    # tnax's search boundary reads the ambient zip-up default
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")


def _pair(seed=3, beta=2, rot=0, noise=False, Nx=2, Ny=2, Nc=4):
    J = make_chimera_like(np.random.default_rng(seed), Nx, Ny, Nc)
    pair = (tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J),
            tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J,
                      device="cpu"))
    for s in pair:
        s.rotate_graph(rot=rot)
        if noise:
            np.random.seed(11)
            s.add_noise(1e-3)
    return pair


def assert_same_result(got, want, tol=1e-10):
    """States and degeneracy exactly; energies, log2-probabilities and
    the diagnostics within ``tol``."""
    assert np.array_equal(got.states, want.states)
    assert got.degeneracy == want.degeneracy
    for k in ("energy", "probability"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=tol, err_msg=k)
    for k in ("discarded_probability", "negative_probability",
              "negative_probability_core"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), abs=tol), k


@pytest.mark.parametrize("rot,noise", [(0, False), (1, False), (2, False),
                                       (3, False), (2, True)])
def test_host_search_matches_tnax(rot, noise):
    ins_j, ins = _pair(rot=rot, noise=noise)
    ins_j.search_ground_state(**KW)
    kernels.reset_launch_counts()
    ins.search_ground_state(omega=tnax_omega, **KW)
    assert_same_result(ins, ins_j)
    assert ins.rotation == ins_j.rotation == rot
    assert ins.count_max > 0
    if not noise:
        # the decoded spins' energy under the couplings given
        J = make_chimera_like(np.random.default_rng(3), 2, 2, 4)
        np.testing.assert_allclose(tt.energy_Jij(J, ins.binary_states()),
                                   ins.energy, atol=1e-9)
    # the wrappers ran their plain versions: no launch on the CPU
    assert kernels.launch_counts()["marginal_epilogue"] == 0


def test_host_search_without_cutoff_matches_tnax():
    """relative_P_cutoff=0 keeps every candidate: the whole search, and
    the 256 branches of the beam after the first row."""
    ins_j, ins = _pair(rot=1)
    kw = dict(KW, M=256, relative_P_cutoff=0)
    ins_j.search_ground_state(**kw)
    ins.search_ground_state(omega=tnax_omega, **kw)
    assert_same_result(ins, ins_j)
    want = jsearch.search_ground_state(ins_j._context(), **kw,
                                       _stop_after_rows=1)
    got = search.search_ground_state(ins._context(), omega=tnax_omega, **kw,
                                     _stop_after_rows=1)
    assert np.array_equal(got.states, want.states)
    assert len(got.probability) == 256
    np.testing.assert_allclose(got.energy, want.energy, rtol=0, atol=1e-10)
    # the beam's tail reaches log2 P ~ -100, where the marginals' relative
    # rounding (~1e-11) is no longer below 1e-10 absolute
    np.testing.assert_allclose(got.probability, want.probability, rtol=1e-9,
                               atol=1e-10)


def _zero_marginal_site(seed, dtype):
    """A site whose states 2 and 7 have no Boltzmann weight: their
    marginals are exactly zero for every branch."""
    rng = np.random.default_rng(seed)
    lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid = marginal_inputs(
        rng, M=48)
    lB[[2, 7]] = -np.inf
    lidx = np.where(lidx == 3, 0, lidx)   # no branch on the empty leg
    # nonnegative environments: no marginal is clamped up from zero
    AT, RL, RRsel = np.abs(AT), np.abs(RL), np.abs(RRsel)
    K = 40
    prob = -np.abs(rng.standard_normal(K)) * 3
    prob[5] = -np.inf                       # a branch of zero probability
    arrays = [np.asarray(a, dtype) for a in (lB, AT, RL, RRsel)]
    return arrays, drindex, lidx, uidx, nvalid, K, prob


@pytest.mark.parametrize("cutoff", [0, 1e-6])
def test_expand_candidates_zero_marginals_match_tnax(cutoff):
    """tnax's float64 table takes log2 of zero marginals as -inf; K3
    writes NEG, which the port maps back: the candidates, their
    log2-probabilities (-inf where tnax's are), pd_max and the
    negativeness agree, with and without a cutoff."""
    (lB, AT, RL, RRsel), drindex, lidx, uidx, nvalid, K, prob = \
        _zero_marginal_site(9, np.float64)
    M, Np = 48, lB.shape[0]
    Pn, mPn = jengine.marginal_step(
        *(jnp.asarray(a) for a in (lB, drindex, AT, RL, RRsel, lidx, uidx)),
        nvalid)
    assert int(jnp.sum(Pn[:K, :nvalid] == 0)) > K
    want = jsearch.expand_candidates(Pn, mPn, prob, K, nvalid, Np, M, cutoff,
                                     -np.inf)
    t = [torch.as_tensor(a) for a in (lB, AT, RL, RRsel)]
    p = torch.full((M,), parallel.NEG, dtype=torch.float64)
    p[:K] = torch.as_tensor(np.maximum(prob, parallel.NEG))
    probf, _, pmax, mq, mqc = engine.marginal_probf(
        kernels.marginal.boltzmann_columns(t[0][None]),
        torch.as_tensor(drindex).long()[None], t[1][None], t[2][None],
        t[3][None], torch.as_tensor(lidx).long()[None],
        torch.as_tensor(uidx).long()[None], torch.tensor([nvalid]), p[None],
        (torch.arange(M) < K)[None],
        float(np.log2(cutoff)) if cutoff else parallel.NEG)
    got = search.expand_candidates(probf, pmax, mq, mqc, prob, K, nvalid, Np,
                                   M, cutoff, -np.inf)
    if cutoff == 0:
        assert np.isneginf(got[2]).sum() > 2 * K
    assert np.array_equal(np.isneginf(got[2]), np.isneginf(want[2]))
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-10)
    # argpartition's order among equal values is its own: compare sets
    assert sorted(zip(got[0], got[1])) == sorted(zip(want[0], want[1]))
    for g, w in zip(got[3:], want[3:]):
        assert g == pytest.approx(w, abs=1e-12)


def test_checkpoint_resume_either_package(tmp_path):
    """A search stopped after its first row and resumed from the
    checkpoint equals the uninterrupted search; a checkpoint that tnax
    wrote resumes in the port."""
    ins_j, ins = _pair(seed=5, Nx=2, Ny=3)
    want = jsearch.search_ground_state(ins_j._context(), **KW)
    full = search.search_ground_state(ins._context(), omega=tnax_omega,
                                      **KW)
    assert_same_result(full, want)
    for writer in ("port", "tnax"):
        path = str(tmp_path / writer)
        if writer == "tnax":
            jsearch.search_ground_state(ins_j._context(), **KW,
                                        checkpoint_path=path,
                                        _stop_after_rows=1)
        else:
            search.search_ground_state(ins._context(), omega=tnax_omega,
                                       **KW, checkpoint_path=path,
                                       _stop_after_rows=1)
        assert int(np.load(path + ".npz")["ny"]) == 1
        got = search.search_ground_state(ins._context(), omega=tnax_omega,
                                         **KW, checkpoint_path=path,
                                         resume=True)
        assert_same_result(got, want)
        assert int(np.load(path + ".npz")["ny"]) == 3


def test_host_search_chimera128_matches_tnax():
    path = os.path.join(DATA, "chimera128_synth_s0.txt")
    J = tnax.round_Jij(tnax.Jij_f2p(tnax.load_Jij(path)), 1 / 75)
    ins_j = tnax.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                    device="cpu")
    kw = dict(M=256, relative_P_cutoff=1e-8, Dmax=8)
    ins_j.search_ground_state(**kw)
    ins.search_ground_state(omega=tnax_omega, **kw)
    assert_same_result(ins, ins_j)
    np.testing.assert_allclose(tt.energy_Jij(J, ins.binary_states()),
                               ins.energy, atol=1e-9)


def test_fast_path_expand_candidates_matches_tnax():
    """tnax's float32 fast path (device top-CAND_CAP candidates) and the
    port's on the same float32 inputs: the marginals of 48 branches of a
    16-state site, 40 of them valid, with a cutoff that keeps some hundred
    candidates, all within 8 of zero (where float32's spacing is 5e-7)."""
    rng = np.random.default_rng(8)
    lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid = marginal_inputs(
        rng, M=48)
    K, M, Np, cutoff = 40, 48, lB.shape[0], 1e-2
    prob = -np.abs(rng.standard_normal(K)) * 0.5
    f32 = [np.asarray(np.abs(a) if k else a, np.float32)
           for k, a in enumerate((lB, AT, RL, RRsel))]
    Pn, mPn = jengine.marginal_step(
        *(jnp.asarray(a) for a in (f32[0], drindex, f32[1], f32[2], f32[3],
                                   lidx, uidx)), nvalid)
    assert Pn.dtype == jnp.float32
    want = jsearch.expand_candidates(Pn, mPn, prob, K, nvalid, Np, M,
                                     cutoff, -np.inf)
    t = [torch.as_tensor(a) for a in f32]
    valid = torch.arange(M) < K
    p = torch.full((M,), parallel.NEG, dtype=torch.float32)
    p[:K] = torch.as_tensor(prob, dtype=torch.float32)
    probf, _, pmax, mq, mqc = engine.marginal_probf(
        kernels.marginal.boltzmann_columns(t[0][None]),
        torch.as_tensor(drindex).long()[None], t[1][None], t[2][None],
        t[3][None], torch.as_tensor(lidx).long()[None],
        torch.as_tensor(uidx).long()[None], torch.tensor([nvalid]), p[None],
        valid[None], float(np.log2(cutoff)))
    got = search.expand_candidates(probf, pmax, mq, mqc, prob, K, nvalid, Np,
                                   M, cutoff, -np.inf)
    inds, indc, vals = got[:3]
    assert 100 < len(vals) == len(want[2]) < M * Np
    assert vals.min() > -8
    np.testing.assert_allclose(vals, want[2], rtol=0, atol=1e-6)
    # the same candidates in the same order, away from ties
    gap = np.diff(vals)
    clear = np.r_[True, gap < -1e-5] & np.r_[gap < -1e-5, True]
    assert clear.sum() > 50
    assert np.array_equal(inds[clear], want[0][clear])
    assert np.array_equal(indc[clear], want[1][clear])
    for g, w in zip(got[3:], want[3:]):
        assert g == pytest.approx(w, abs=1e-6)


def test_device_search_gs_matches_tnax():
    ins_j, ins = _pair(seed=6, rot=1)
    kw = dict(KW, M=32, cand_factor=4)
    want = jpar.device_search_gs(ins_j._context(), **kw)
    got = parallel.device_search_gs(ins._context(), omega=tnax_omega, **kw)
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    for k in ("degeneracy", "merge_overflow", "count_max"):
        assert got[k] == want[k], k
    for k in ("energy", "prob", "negative_probability",
              "negative_probability_core", "discarded_probability"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-10), k
    # the Solver's device path: the same search, its energy rechecked
    ins_j.search_ground_state(path="device", **KW)
    ins.search_ground_state(path="device", omega=tnax_omega, **KW)
    assert_same_result(ins, ins_j)
    assert ins.merge_overflow == ins_j.merge_overflow


def test_multi_search_gs_matches_tnax_per_instance():
    pairs = [_pair(seed=s) for s in (21, 22, 23)]
    kw = dict(KW, M=32, cand_factor=None)
    want = jpar.multi_search_gs([p[0]._context() for p in pairs], **kw)
    got = parallel.multi_search_gs([p[1]._context() for p in pairs],
                                   omega=tnax_omega, **kw)
    assert len(got) == len(want) == 3
    for g, w, (ins_j, ins) in zip(got, want, pairs):
        assert np.array_equal(g["states"], np.asarray(w["states"]))
        assert g["degeneracy"] == w["degeneracy"]
        # tnax's fleet is one vmapped program, whose batched products
        # round otherwise than its single search; the diagnostics as
        # test_torch_fleet holds the fleet's
        for k in ("energy", "prob"):
            assert g[k] == pytest.approx(float(w[k]), abs=1e-8), k
        for k in ("discarded_probability", "negative_probability",
                  "negative_probability_core"):
            assert g[k] == pytest.approx(float(w[k]), rel=1e-6,
                                         abs=1e-12), k
        # and each instance's device_search_gs alone
        one = parallel.device_search_gs(ins._context(), omega=tnax_omega,
                                        **kw)
        assert np.array_equal(one["states"], g["states"])
        assert one["energy"] == pytest.approx(g["energy"], abs=1e-12)


def test_solver_device_path_is_the_flagship_search():
    """The Solver's precondition + device search under the flagship's
    ladder arguments (one rung at D=8, 20 sweeps) and boundary sweeps
    gives the flagship's states bit for bit: one search body."""
    _, ins = _pair(seed=9, Nx=3, Ny=3)
    kw = dict(M=32, relative_P_cutoff=1e-8, Dmax=8, max_sweeps=2)
    want = parallel.flagship_search_gs(ins, omega=tnax_omega, **kw)
    ins.precondition(steps=1, path="device", omega=tnax_omega)
    ins.search_ground_state(path="device", omega=tnax_omega, **kw)
    assert np.array_equal(ins.states[0][ins.order_i], want["states"])
    assert ins.degeneracy == want["degeneracy"]
    assert ins.energy[0] == pytest.approx(want["energy"], abs=1e-12)


def test_context_functions_take_tnax_keywords():
    """Every keyword of tnax's context functions, at tnax's defaults (a few
    shrunk), is accepted; fused=False runs the same search."""
    import inspect
    _, ins = _pair()
    small = dict(M=16, Dmax=4)
    for name in ("device_search_gs", "multi_search_gs", "device_sample",
                 "multi_sample"):
        params = list(inspect.signature(getattr(jpar, name)).parameters
                      .values())
        kw = {p.name: p.default for p in params[1:]}
        kw.update({k: v for k, v in small.items() if k in kw})
        arg = [ins._context()] if name.startswith("multi") \
            else ins._context()
        out = getattr(parallel, name)(arg, **kw)
        assert len(out[0] if name.startswith("multi") else out) > 0, name
    a = parallel.device_search_gs(ins._context(), fused=False, **small)
    b = parallel.device_search_gs(ins._context(), fused=True, **small)
    assert np.array_equal(a["states"], b["states"])
    with pytest.raises(TypeError, match="make_mesh"):
        parallel.multi_search_gs([ins._context()], mesh="data", **small)
    with pytest.raises(ValueError, match="one instance"):
        parallel.device_search_gs(tt.search.ContractionContext([ins, ins]),
                                  **small)
