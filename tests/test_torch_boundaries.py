"""Port parity of the boundary-MPS building blocks and stack builds against
tnax, in float64 on the CPU: canonize_left, pad_bond, apply_mpo,
variational_compress and compress (tnax_torch.bmps), the fat-path row
absorption and the four stack functions build_rhoT/B/L/R with the
two-lane build_rho_lr (tnax_torch.engine), at 3x3 Nc=2 and 3x4 Nc=4,
with tnax's sketch matrices. QR and SVD leave the basis of degenerate
and exactly-zero channels free, so states compare as dense vectors; the
interfaces of the four stacks give the brute-force partition function."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
import tnax_torch as tt
from tnax import bmps as jbmps
from tnax import engine as jengine
from tnax.search import ContractionContext as JContext
from tnax_torch import bmps, engine, interop
from test_search_small import make_chimera_like
from torch_helpers import dense, tnax_omega


@pytest.fixture(autouse=True)
def _tnax_sketch(monkeypatch):
    # tnax's stack functions read the ambient zip-up default
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")


def _same_state(got_A, got_ln, ref_A, ref_ln, rtol=1e-10):
    a, b = dense(got_A, got_ln), dense(np.asarray(ref_A), ref_ln)
    assert np.linalg.norm(a - b) <= rtol * np.linalg.norm(b)


def _same_direction(got_A, ref_A, tol=1e-10):
    a, b = dense(got_A, 0.0), dense(np.asarray(ref_A), 0.0)
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    assert np.linalg.norm(a - b) <= tol


def _raw(seed, L=4, D=16, d=4):
    """A raw random MPS of tnax and the port (a canonical one has a flat,
    fully degenerate bond spectrum: its truncation is gauge freedom)."""
    m = jbmps.init_mps(L, D, d, jnp.float64, initial="randR",
                       canonize="none", seed=seed)
    return m, interop.mps(m.A, m.lognorm, "cpu", torch.float64)


@pytest.mark.parametrize("compress", [False, True])
def test_canonize_left_matches_tnax(compress):
    m, t = _raw(3)
    kw = dict(compress=True, cap=5, tol=1e-14) if compress else {}
    ref, dref = jbmps.canonize_left(m, **kw)
    got, d = bmps.canonize_left(t, **kw)
    _same_state(got.A[0].numpy(), got.lognorm[0].numpy(), ref.A, ref.lognorm)
    assert float(d[0]) == pytest.approx(float(dref), rel=1e-10, abs=1e-300)


def _row(seed, L=3, D=4, d=4, lh=3):
    rng = np.random.default_rng(seed)
    m = jbmps.init_mps(L, D, d, jnp.float64, initial="randR",
                       canonize="right", seed=seed)
    return m, rng.standard_normal((L, lh, d, lh, d))


@pytest.mark.parametrize("conj", [True, False])
def test_apply_mpo_and_pad_bond_match_tnax(conj):
    m, W = _row(1)
    ref = jbmps.apply_mpo(m, jnp.asarray(W), conj=conj)
    got = bmps.apply_mpo(interop.mps(m.A, m.lognorm, "cpu", torch.float64),
                         torch.as_tensor(W)[None], conj=conj)
    np.testing.assert_allclose(got.A[0].numpy(), np.asarray(ref.A),
                               rtol=1e-12, atol=1e-15)
    padded = bmps.pad_bond(got, 16)
    want = jbmps.pad_bond(ref, 16)
    assert padded.A.shape == (1, 3, 16, 4, 16)
    np.testing.assert_allclose(padded.A[0].numpy(), np.asarray(want.A),
                               rtol=1e-12, atol=1e-15)
    assert bmps.pad_bond(padded, 16) is padded


def _fat_target(seed):
    """A fat MPS (bond 12) of a row applied to a random MPS, in both
    packages."""
    m, W = _row(seed)
    fat = jbmps.apply_mpo(m, jnp.asarray(W), conj=True)
    return fat, interop.mps(fat.A, fat.lognorm, "cpu", torch.float64)


def test_variational_compress_matches_tnax():
    fat, fat_t = _fat_target(2)
    phi, _ = jbmps.canonize_right(fat)
    phi_t, _ = bmps.canonize_right(fat_t)
    start, _ = jbmps.canonize_left(phi, compress=True, cap=4, tol=1e-16)
    start = jbmps.slice_bond(start, 4)
    start_t, _ = bmps.canonize_left(phi_t, compress=True, cap=4, tol=1e-16)
    start_t = bmps.slice_bond(start_t, 4)
    ref, ov = jbmps.variational_compress(start, phi.A, tol=1e-12,
                                         max_sweeps=6)
    got, ov_t, sweeps = bmps.variational_compress(start_t, phi_t.A,
                                                  tol=1e-12, max_sweeps=6)
    _same_state(got.A[0].numpy(), got.lognorm[0].numpy(), ref.A, ref.lognorm)
    assert float(ov_t[0]) == pytest.approx(float(ov), rel=1e-10)
    assert 1 <= int(sweeps[0]) <= 6


@pytest.mark.parametrize("graduate", [True, False])
def test_compress_matches_tnax(graduate):
    fat, fat_t = _fat_target(4)
    kw = dict(tolS=1e-16, tolV=1e-12, max_sweeps=8, graduate=graduate)
    ref, ov, disc = jbmps.compress(fat, 3, **kw)
    got, ov_t, disc_t, _ = bmps.compress(fat_t, 3, **kw)
    assert got.A.shape == (1, 3, 3, 4, 3)
    _same_state(got.A[0].numpy(), got.lognorm[0].numpy(), ref.A, ref.lognorm)
    assert float(ov_t[0]) == pytest.approx(float(ov), rel=1e-10)
    assert float(disc_t[0]) == pytest.approx(float(disc), rel=1e-8)


def _instance(Nx, Ny, Nc, seed=0, beta=1.0):
    J = make_chimera_like(np.random.default_rng(seed), Nx, Ny, Nc)
    ins_j = tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J)
    ins = tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J,
                    device="cpu")
    return J, JContext(ins_j.problem, beta), ins


STACKS = ["build_rhoT", "build_rhoB", "build_rhoL", "build_rhoR"]


@pytest.mark.parametrize("name", STACKS)
@pytest.mark.parametrize("method,size", [("zipup", (3, 3, 2)),
                                         ("zipup", (3, 4, 4)),
                                         ("fat", (3, 3, 2))])
def test_stacks_match_tnax(name, method, size):
    _, ctx_j, ins = _instance(*size)
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-10, max_sweeps=6, graduate=True,
              method=method)
    ref = getattr(jengine, name)(ctx_j.Wt, **kw)
    rho, lns, ovs, _ = getattr(engine, name)(ins._context().Wt,
                                             omega=tnax_omega, **kw)
    for k in range(rho.shape[1]):
        _same_direction(rho[0, k].numpy(), ref[0][k])
    np.testing.assert_allclose(ovs[0].numpy(), np.asarray(ref[-2]),
                               rtol=1e-10)
    if name == "build_rhoT":
        for k in range(rho.shape[1]):
            _same_state(rho[0, k].numpy(), lns[0, k].numpy(), ref[0][k],
                        ref[1][k])


def test_fat_rhoT_at_full_leg_width():
    """The fat path with graduate truncation at lh = lv = 16 (fat bond
    64, first stage capped at 4*Dmax = 16)."""
    _, ctx_j, ins = _instance(3, 4, 4, seed=2)
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-10, max_sweeps=4, graduate=True,
              method="fat")
    rhoT, lns, ovs, _ = jengine.build_rhoT(ctx_j.Wt, **kw)
    got, lns_t, ovs_t, _ = engine.build_rhoT(ins._context().Wt, **kw)
    for k in range(got.shape[1]):
        _same_state(got[0, k].numpy(), lns_t[0, k].numpy(), rhoT[k], lns[k])
    np.testing.assert_allclose(ovs_t[0].numpy(), np.asarray(ovs), rtol=1e-10)


def test_build_rho_lr_is_the_column_stacks():
    """The two-lane column build equals build_rhoL and build_rhoR per
    instance, over a fleet of two."""
    J1 = make_chimera_like(np.random.default_rng(5), 3, 4, 2)
    J2 = make_chimera_like(np.random.default_rng(6), 3, 4, 2)
    ctx = tt.search.ContractionContext(
        [tt.Solver(mode="Ising", Nx=3, Ny=4, Nc=2, beta=1, J=J,
                   device="cpu") for J in (J1, J2)])
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-10, max_sweeps=6, rsvd=False)
    rhoL, rhoR = engine.build_rho_lr(ctx.Wt, **kw)
    for b in range(2):
        one = ctx.Wt[b:b + 1]
        torch.testing.assert_close(rhoL[b], engine.build_rhoL(one, **kw)[0][0],
                                   rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(rhoR[b], engine.build_rhoR(one, **kw)[0][0],
                                   rtol=1e-12, atol=1e-14)


def _log2Z(J, L, beta, ctx):
    """Brute-force log2 of the network's contraction: Z times
    exp(beta * the sum of the per-site table minima)."""
    bits = ((np.arange(2 ** L)[:, None] >> np.arange(L)[None, :]) & 1)
    E = tt.energy_Jij(J, 1 - bits)
    m = E.min()
    log2Z = np.log2(np.sum(np.exp(-beta * (E - m)))) - beta * m / np.log(2)
    off = sum(t.min() for ny in range(ctx.Ny) for nx in range(ctx.Nx)
              for t in ctx.energy_tables(ny, nx))
    return log2Z + beta * off / np.log(2)


def _interface_log2Z(a, la, b, lb):
    return np.log2(abs(float(bmps.mps_dot(a, b)))) + float(la) + float(lb)


@pytest.mark.parametrize("gauged", [False, True])
def test_interfaces_give_the_partition_function(gauged):
    """At D=16, above the exact rank, every row interface
    (<rhoT[k]|rhoB[k]>) and every column interface (<rhoR[k]|rhoL[k]>),
    with the stacks' lognorms, gives the brute-force partition function,
    as does rhoT[0] against the trivial boundary; also on the gauges of
    the host preconditioner in both directions, which leave the
    contraction unchanged."""
    J, _, ins = _instance(3, 3, 2)
    if gauged:
        ins.precondition(path="host", directions=("ud", "lr"),
                         omega=tnax_omega)
    ctx = ins._context()
    want = _log2Z(J, 18, 1.0, ctx)
    kw = dict(Dmax=16, tolS=1e-16, tolV=1e-12, max_sweeps=20,
              omega=tnax_omega)
    rhoT, lnT, _, _ = engine.build_rhoT(ctx.Wt, **kw)
    rhoB, lnB, _, _ = engine.build_rhoB(ctx.Wt, **kw)
    rhoL, lnL, _, _ = engine.build_rhoL(ctx.Wt, **kw)
    rhoR, lnR, _, _ = engine.build_rhoR(ctx.Wt, **kw)
    got = [_interface_log2Z(rhoT[0, 0], lnT[0, 0], rhoB[0, 0], lnB[0, 0])]
    got += [_interface_log2Z(rhoT[0, k], lnT[0, k], rhoB[0, k], lnB[0, k])
            for k in (1, 2)]
    got += [_interface_log2Z(rhoR[0, k], lnR[0, k], rhoL[0, k], lnL[0, k])
            for k in (1, 2)]
    for g in got:
        assert g == pytest.approx(want, abs=1e-5)


def test_zipup_matches_fat_marginals():
    """Both compression methods land on the same boundary MPS: the
    first site's marginals computed from each agree (tnax's
    test_zipup_matches_fat_path)."""
    _, _, ins = _instance(3, 3, 2, seed=1, beta=2.0)
    ctx = ins._context()
    kw = dict(Dmax=4, tolS=1e-16, tolV=1e-12, max_sweeps=30,
              graduate=True, omega=tnax_omega)
    rho_zip = engine.build_rhoT(ctx.Wt, method="zipup", **kw)[0]
    rho_fat = engine.build_rhoT(ctx.Wt, method="fat", **kw)[0]
    M, D = 4, 4
    RL = torch.zeros((1, M, D), dtype=torch.float64)
    RL[:, :, 0] = 1.0
    z = torch.zeros((1, M), dtype=torch.int64)

    def marg(rho):
        RRs = engine.row_right_envs(rho[:, 1], ctx.Wt[:, 0],
                                    torch.zeros((1, M, 3), dtype=torch.int64))
        Pn, _ = engine.marginal_step(
            ctx.lB[:, 0, 0], ctx.drindex[:, 0, 0], rho[:, 1, 0], RL,
            RRs[:, 0], z, z, torch.as_tensor(ctx.nstates[:, 0, 0]))
        return Pn[0, 0].numpy()

    np.testing.assert_allclose(marg(rho_zip), marg(rho_fat), atol=1e-8)
