"""Port parity of the MPS API (tnax_torch.bmps: init_mps, identity_mpo,
mpo_from_block, the expectation values, the measurements, mps_dot,
describe; interop.mps) against tnax and against dense contractions, at
the sizes of tnax's tests/test_mps_api.py, in float64 (and complex128)
on the CPU. The functions take tnax's shapes, without the instance
axis, and batched ones; QR leaves the basis of exactly-zero channels
free, so canonized states compare as dense vectors."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tnax import bmps as jbmps
from tnax_torch import bmps, interop
from test_bmps import dense_state, random_mps
import torch_helpers  # noqa: F401  (the thread policy)

CPU = dict(device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _dense(mps):
    """The dense vector of an unbatched MPS times 2**lognorm."""
    return dense_state(np.asarray(mps.A)) * 2.0 ** float(mps.lognorm)


@pytest.mark.parametrize("canonize", ["left", "right", "none"])
@pytest.mark.parametrize("initial", ["X", "Z", "randR", "randC"])
def test_init_mps_matches_tnax(initial, canonize):
    ref = jbmps.init_mps(4, 4, 3, jnp.float64, initial=initial,
                         canonize=canonize, seed=5, valid_D=3)
    got = bmps.init_mps(4, 4, 3, torch.float64, initial=initial,
                        canonize=canonize, seed=5, valid_D=3, **CPU)
    assert got.A.shape == (4, 4, 3, 4) and got.lognorm.shape == ()
    assert got.A.dtype == (torch.complex128 if initial == "randC"
                           else torch.float64)
    assert got.lognorm.dtype == torch.float64
    a, b = _dense(got), _dense(ref)
    assert np.linalg.norm(a - b) <= 1e-10 * np.linalg.norm(b)
    if canonize == "none":
        assert np.array_equal(got.A.numpy(), np.asarray(ref.A))


@pytest.mark.parametrize("initial", ["randR", "randC"])
def test_canonized_sites_are_isometries(initial):
    """Left-canonical sites satisfy sum_a A^H A = P and right-canonical
    ones A A^H = P, P a projector, complex included; a batched call
    equals the unbatched one per instance."""
    for canon, eq in (("left", "adb,adc->bc"), ("right", "adb,cdb->ac")):
        m = bmps.init_mps(5, 6, 2, torch.float64, initial=initial,
                          canonize=canon, seed=1, **CPU)
        for n in (range(4) if canon == "left" else range(1, 5)):
            An = m.A[n].numpy()
            G = np.einsum(eq, An.conj(), An)
            s = np.linalg.svd(G, compute_uv=False)
            assert np.all((np.abs(s - 1) < 1e-10) | (np.abs(s) < 1e-10))
        raw = bmps.init_mps(5, 6, 2, torch.float64, initial=initial,
                            canonize="none", seed=1, **CPU)
        fn = bmps.canonize_left if canon == "left" else bmps.canonize_right
        two = bmps.MPS(A=torch.stack([raw.A, 2 * raw.A]),
                       lognorm=torch.zeros(2, dtype=torch.float64))
        out, disc = fn(two)
        assert out.A.shape[0] == 2 and disc.shape == (2,)
        one, _ = fn(raw)
        torch.testing.assert_close(out.A[0], one.A, rtol=1e-12, atol=1e-14)
        # twice every one of the 5 sites: 2**5 times the state
        torch.testing.assert_close(out.lognorm[1], one.lognorm + 5,
                                   rtol=1e-12, atol=1e-14)


def test_identity_mpo_and_mpo_from_block():
    for initial in ("X", "Z", "randR"):
        m = bmps.init_mps(4, 4, 2, torch.float64, initial=initial, **CPU)
        W = bmps.identity_mpo(4, 2, 2, torch.float64, **CPU)
        assert torch.equal(W, _t(jbmps.identity_mpo(4, 2, 2, jnp.float64)))
        e = float(bmps.expectation_mpo(m.A, W, m.A))
        assert e == pytest.approx(float(bmps.mps_dot(m.A, m.A)), rel=1e-10)
    blk = torch.arange(16.0, dtype=torch.float64).reshape(4, 4)
    t = bmps.mpo_from_block(blk, 2, 2)
    assert t.shape == (2, 2, 2, 2) and float(t[1, 0, 1, 1]) == blk[2, 3]
    assert np.array_equal(t.numpy(), np.asarray(jbmps.mpo_from_block(
        jnp.asarray(blk.numpy()), 2, 2)))


def test_expectations_match_tnax():
    """expectation_mpo, mpo_envs_at, expectation_1mpo_mix and the list
    variant against tnax; the mixes against the full sandwich with the
    modified MPO."""
    rng = np.random.default_rng(4)
    L, D, d, lh = 5, 3, 2, 3
    bra = jbmps.init_mps(L, D, d, jnp.float64, initial="randR", seed=1).A
    ket = jbmps.init_mps(L, D, d, jnp.float64, initial="randR", seed=2).A
    W = rng.standard_normal((L, lh, d, lh, d))
    tb, tk, tW = _t(bra), _t(ket), _t(W)
    assert float(bmps.expectation_mpo(tb, tW, tk)) == pytest.approx(
        float(jbmps.expectation_mpo(bra, jnp.asarray(W), ket)), rel=1e-10)
    for n in (0, 2, L - 1):
        for a, b in zip(bmps.mpo_envs_at(tb, tW, tk, n),
                        jbmps.mpo_envs_at(bra, jnp.asarray(W), ket, n)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-14)
        Wn = rng.standard_normal((lh, d, lh, d))
        got = float(bmps.expectation_1mpo_mix(tb, tW, tk, n, _t(Wn)))
        Wmod = W.copy()
        Wmod[n] = Wn
        assert got == pytest.approx(float(bmps.expectation_mpo(
            tb, _t(Wmod), tk)), rel=1e-10)
        assert got == pytest.approx(float(jbmps.expectation_1mpo_mix(
            bra, jnp.asarray(W), ket, n, jnp.asarray(Wn))), rel=1e-10)
        Wns = rng.standard_normal((4, lh, d, lh, d))
        gotl = bmps.expectation_list_1mpo_mix(tb, tW, tk, n, _t(Wns))
        wantl = jbmps.expectation_list_1mpo_mix(bra, jnp.asarray(W), ket, n,
                                                jnp.asarray(Wns))
        np.testing.assert_allclose(gotl.numpy(), np.asarray(wantl),
                                   rtol=1e-10)


def _apply(O, n, psi):
    c = np.tensordot(O, psi, axes=(1, n))
    return np.moveaxis(c, 0, n)


def test_measure_O1_and_correlations_match_dense_and_tnax():
    rng = np.random.default_rng(1)
    A = random_mps(rng, L=4, D=3, d=2, Dpad=4)
    psi = dense_state(A).reshape([2] * 4)
    norm = np.sum(psi ** 2)
    O = rng.normal(size=(2, 2))
    got = bmps.measure_O1(_t(A), _t(O)).numpy()
    for n in range(4):
        assert got[n] == pytest.approx(np.sum(psi * _apply(O, n, psi))
                                       / norm, rel=1e-9)
    np.testing.assert_allclose(got, np.asarray(jbmps.measure_O1(
        A, jnp.asarray(O))), rtol=1e-10)
    Os = rng.normal(size=(4, 2, 2))        # one operator per site
    np.testing.assert_allclose(bmps.measure_O1(_t(A), Os).numpy(),
                               np.asarray(jbmps.measure_O1(
                                   A, jnp.asarray(Os))), rtol=1e-10)
    Z = np.diag([1.0, -1.0])
    C = bmps.measure_correlations(_t(A), _t(Z)).numpy()
    for n in range(4):
        for m in range(4):
            p = _apply(Z, n, psi) if n == m \
                else _apply(Z, n, _apply(Z, m, psi))
            assert C[n, m] == pytest.approx(np.sum(psi * p) / norm, rel=1e-8)
    np.testing.assert_allclose(C, jbmps.measure_correlations(A, Z),
                               rtol=1e-10)


def test_measure_O2_matches_dense_and_tnax():
    rng = np.random.default_rng(3)
    A = random_mps(rng, L=4, D=3, d=2, Dpad=4)
    psi = dense_state(A).reshape([2] * 4)
    norm = np.sum(psi ** 2)
    O = rng.normal(size=(2, 2, 2, 2))
    got = bmps.measure_O2(_t(A), _t(O)).numpy()
    for n in range(3):
        c = np.tensordot(O, psi, axes=([2, 3], [n, n + 1]))
        c = np.moveaxis(c, [0, 1], [n, n + 1])
        assert got[n] == pytest.approx(np.sum(psi * c) / norm, rel=1e-9)
    np.testing.assert_allclose(got, jbmps.measure_O2(A, O), rtol=1e-10)


def test_batched_measurements_are_per_instance():
    rng = np.random.default_rng(6)
    As = [random_mps(rng, L=4, D=3, d=2, Dpad=4) for _ in range(3)]
    Ab = _t(np.stack(As))
    O1, O2 = rng.normal(size=(2, 2)), rng.normal(size=(2, 2, 2, 2))
    for fn, O in ((bmps.measure_O1, O1), (bmps.measure_O2, O2),
                  (bmps.measure_correlations, O1)):
        out = fn(Ab, _t(O))
        for b in range(3):
            torch.testing.assert_close(out[b], fn(_t(As[b]), _t(O)),
                                       rtol=1e-12, atol=1e-14)
    dots = bmps.mps_dot(Ab, Ab)
    assert dots.shape == (3,)
    assert float(dots[1]) == pytest.approx(float(jbmps.mps_dot(As[1],
                                                               As[1])))


def test_describe_matches_tnax():
    rng = np.random.default_rng(4)
    A = random_mps(rng, L=3, D=2, d=2, Dpad=4)
    s = bmps.describe(bmps.MPS(A=_t(A), lognorm=torch.zeros(())))
    assert s == jbmps.describe(jbmps.MPS(A=A, lognorm=jnp.zeros(())))
    assert "L=3" in s and "ranks" in s
    m = jbmps.init_mps(4, 4, 2, jnp.float64, initial="randR", seed=3)
    got = bmps.init_mps(4, 4, 2, torch.float64, initial="randR", seed=3,
                        **CPU)
    assert bmps.describe(got) == jbmps.describe(m)


def test_randC_through_interop_and_mps_dot():
    """A complex tnax MPS comes across with its phase (interop.mps) and
    gives tnax's <phi|psi>; <conj(A)|A> is real and positive."""
    m = jbmps.init_mps(3, 4, 2, jnp.float64, initial="randC",
                       canonize="right")
    t = interop.mps(m.A, m.lognorm, "cpu", torch.float64)
    assert t.A.dtype == torch.complex128 and t.lognorm.dtype == torch.float64
    assert t.A.shape == (1, 3, 4, 2, 4)
    n = complex(bmps.mps_dot(t.A[0].conj(), t.A[0]))
    assert n == pytest.approx(complex(jbmps.mps_dot(np.conj(m.A), m.A)),
                              rel=1e-12)
    assert abs(n.imag) < 1e-10 and n.real > 0
    got = bmps.init_mps(3, 4, 2, torch.float64, initial="randC",
                        canonize="right", **CPU)
    a, b = _dense(got), _dense(m)
    assert np.linalg.norm(a - b) <= 1e-10 * np.linalg.norm(b)
    # the whole chain of complex measurements agrees with tnax
    O = np.diag([1.0, -1.0])
    np.testing.assert_allclose(bmps.measure_O1(got.A, O).numpy(),
                               np.asarray(jbmps.measure_O1(
                                   m.A, jnp.asarray(O))), rtol=1e-9)
