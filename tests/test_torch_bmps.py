"""Port parity of the boundary-MPS layer (tnax_torch.bmps and the stack
builders of tnax_torch.engine) against tnax, in float64 on the CPU.

QR and SVD leave the basis of degenerate and exactly-zero channels free,
so the comparisons are gauge-invariant: the dense state of each MPS
(left and right boundary index 0, times 2**lognorm) and overlaps. The
port's functions take a leading instance axis; one tnax instance is a
batch of one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import bmps as jbmps
from tnax import engine as jengine
from tnax_torch import bmps, engine, interop
from test_search_small import make_chimera_like
from torch_helpers import dense, tnax_omega


def _mps_and_row(seed, L=3, D=8, d=16, lh=16, canonize="right"):
    rng = np.random.default_rng(seed)
    m = jbmps.init_mps(L, D, d, jnp.float64, initial="randR",
                       canonize=canonize, seed=seed)
    W = rng.standard_normal((L, lh, d, lh, d))
    return m, W


def _assert_same_state(got, ref, rtol=1e-10):
    a = dense(got.A[0].numpy(), got.lognorm[0].numpy())
    b = dense(ref.A, ref.lognorm)
    assert np.linalg.norm(a - b) <= rtol * np.linalg.norm(b)


@pytest.mark.parametrize("conj", [True, False])
@pytest.mark.parametrize("rsvd", [False, True])
def test_zipup_apply_matches_tnax(rsvd, conj):
    m, W = _mps_and_row(0)
    ref, disc_ref = jbmps.zipup_apply(m, jnp.asarray(W), 8, conj=conj,
                                      tol=1e-17, rsvd=rsvd)
    # the tensor form of the sketch: L=3 sites, n = D*lh = 128, k = 40
    got, disc = bmps.zipup_apply(
        interop.mps(m.A, m.lognorm, "cpu", torch.float64),
        torch.as_tensor(W)[None], 8, conj=conj, tol=1e-17, rsvd=rsvd,
        omega=tnax_omega(3, 128, 40))
    _assert_same_state(got, ref)
    assert float(disc) == pytest.approx(float(disc_ref), rel=1e-8)


@pytest.mark.parametrize("rsvd", [False, True])
def test_compress_apply_matches_tnax(rsvd):
    m, W = _mps_and_row(2)
    ref, ov_ref, disc_ref = jbmps.compress_apply(
        m, jnp.asarray(W), 4, conj=True, tolS=1e-16, tolV=1e-10,
        max_sweeps=4, rsvd=rsvd)
    got, ov, disc, _ = bmps.compress_apply(
        interop.mps(m.A, m.lognorm, "cpu", torch.float64),
        torch.as_tensor(W)[None], 4, conj=True, tolS=1e-16, tolV=1e-10,
        max_sweeps=4, rsvd=rsvd, omega=tnax_omega)
    _assert_same_state(got, ref)
    assert float(ov) == pytest.approx(float(ov_ref), rel=1e-10)
    assert float(disc) == pytest.approx(float(disc_ref), rel=1e-8)


def test_canonize_right_compress_matches_tnax():
    # a raw random MPS: a canonical one has a flat, fully degenerate
    # bond spectrum, and the truncation choice is then gauge freedom
    m, _ = _mps_and_row(3, L=4, D=16, d=4, canonize="none")
    ref, dref = jbmps.canonize_right(m, compress=True, cap=5, tol=1e-14)
    got, d = bmps.canonize_right(
        interop.mps(m.A, m.lognorm, "cpu", torch.float64), compress=True,
        cap=5, tol=1e-14)
    _assert_same_state(got, ref)
    assert float(d) == pytest.approx(float(dref), rel=1e-10)


def _chimera_rows(seed, Nx=4, Ny=3, Nc=2, beta=1.0):
    rng = np.random.default_rng(seed)
    J = make_chimera_like(rng, Nx, Ny, Nc)
    ins = tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J)
    g = jengine.pad_grid(ins.problem)
    X = jengine.identity_gauges(g)
    args = (g.Es, g.Esl, g.Esu, g.dmap, g.rmap, X["Xl"], X["Xr"], X["Xu"],
            X["Xd"])
    lB, Wt = jengine.peps_rows(*(jnp.asarray(a) for a in args), beta,
                               lh=g.lh, lv=g.lv)
    return args, g, lB, Wt


def test_peps_rows_matches_tnax():
    args, g, lB, Wt = _chimera_rows(4)
    lB_t, Wt_t = engine.peps_rows(*(torch.as_tensor(a) for a in args), 1.0,
                                  lh=g.lh, lv=g.lv)
    np.testing.assert_allclose(lB_t.numpy(), np.asarray(lB), rtol=1e-14)
    np.testing.assert_allclose(Wt_t.numpy(), np.asarray(Wt), rtol=1e-14)


def test_build_rhoT_boundary_vectors_match_tnax():
    _, g, _, Wt = _chimera_rows(5)
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-10, max_sweeps=4)
    rhoT, lns, ovs, _ = jengine.build_rhoT(Wt, graduate=False, rsvd=False,
                                           **kw)
    rhoT_t, lns_t, ovs_t, _ = (x[0] for x in engine.build_rhoT(
        torch.as_tensor(np.array(Wt))[None], rsvd=False, **kw))
    for ny in range(g.Ny + 1):
        a = dense(rhoT_t[ny].numpy(), lns_t[ny].numpy())
        b = dense(rhoT[ny], lns[ny])
        assert np.linalg.norm(a - b) <= 1e-10 * np.linalg.norm(b), ny
    np.testing.assert_allclose(ovs_t.numpy(), np.asarray(ovs), rtol=1e-10)


def test_build_rho_both_matches_tnax():
    _, g, _, Wt = _chimera_rows(6)
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-10, max_sweeps=4)
    rhoT, rhoB = jengine.build_rho_both(Wt, graduate=False, rsvd=False, **kw)
    rhoT_t, rhoB_t = (x[0] for x in engine.build_rho_both(
        torch.as_tensor(np.array(Wt))[None], rsvd=False, **kw))
    # build_rho_both drops the lognorms; compare directions of the states
    for ours, ref in ((rhoT_t, rhoT), (rhoB_t, rhoB)):
        for ny in range(g.Ny + 1):
            a = dense(ours[ny].numpy(), 0.0)
            b = dense(ref[ny], 0.0)
            a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
            assert np.linalg.norm(a - b) <= 1e-10, ny
