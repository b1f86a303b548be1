"""Port parity of the three kernel modules (their plain versions, which
the wrappers run on CPU tensors) against tnax and scipy. The kernels
themselves are compared with the plain versions in test_torch_gpu.py.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from tnax import engine as jengine
from tnax import parallel as jpar
from tnax import precondition as jpre
from tnax_torch import engine, interop, kernels, parallel
from torch_helpers import (badly_scaled, candidate_key1, candidate_set,
                           marginal_inputs)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# K1 gebal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5, 8, 12, 16])
def test_gebal_plain_bit_equal_to_scipy_and_tnax(n):
    rng = np.random.default_rng(n)
    As = np.stack([badly_scaled(rng, n) for _ in range(5)])
    got = kernels.gebal_scale_plain(_t(As), _t(np.full(5, n)), 1e30).numpy()
    for b in range(5):
        _, (want, _) = scipy.linalg.matrix_balance(
            As[b], permute=False, separate=True)
        assert np.array_equal(got[b], want), b
        ref = np.asarray(jpre.gebal_scale(jnp.asarray(As[b]),
                                          jnp.asarray(n), 1e30))
        assert np.array_equal(got[b], ref), b


def test_gebal_plain_padding_and_clip():
    rng = np.random.default_rng(1)
    n, nds = 8, np.array([5, 8, 1, 3])
    As = np.stack([rng.standard_normal((n, n)) * np.exp2(
        rng.integers(-30, 30, size=(n, 1))) for _ in nds])
    got = kernels.gebal_scale_plain(_t(As), _t(nds), 32.0).numpy()
    for b, nd in enumerate(nds):
        ref = np.asarray(jpre.gebal_scale(jnp.asarray(As[b]),
                                          jnp.asarray(nd), 32.0))
        assert np.array_equal(got[b], ref), b
        assert (got[b, nd:] == 1.0).all()


# ---------------------------------------------------------------------------
# K2 merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_key1", [True, False])
def test_merge_candidates_plain_matches_tnax(seed, with_key1):
    rng = np.random.default_rng(seed)
    M, C, Nx, bits = 32, 256, 3, 2
    vind, Eng, prob, valid, deg = candidate_set(rng, M, C, Nx, bits)
    limbs = jpar.deg_encode(deg)
    key1 = candidate_key1(vind, valid) if with_key1 else None
    ref = jpar.merge_candidates(
        jnp.asarray(vind), jnp.asarray(Eng), jnp.asarray(prob),
        jnp.asarray(valid), 1e-12, bits, M, deg=jnp.asarray(limbs),
        key1=None if key1 is None else jnp.asarray(key1))
    # the port merges a batch of instances; here a batch of one
    got = parallel.merge_candidates(
        _t(vind)[None], _t(Eng)[None], _t(prob)[None], _t(valid)[None],
        1e-12, bits, M, deg=_t(deg)[None],
        key1=None if key1 is None else _t(key1)[None])
    slot, rep, prob_out, Eng_out, out_valid, disc, deg_out = (
        x[0] for x in got)
    assert np.array_equal(slot.numpy(), np.asarray(ref[0]))
    assert np.array_equal(rep.numpy(), np.asarray(ref[1]))
    assert np.array_equal(out_valid.numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(prob_out.numpy(), np.asarray(ref[2]),
                               rtol=1e-12)
    np.testing.assert_allclose(Eng_out.numpy(), np.asarray(ref[3]),
                               rtol=1e-12)
    assert float(disc) == pytest.approx(float(ref[5]), rel=1e-12)
    assert np.array_equal(deg_out.numpy(), interop.deg_decode(ref[6]))


def test_pack_keys_and_lexsort_match_tnax():
    rng = np.random.default_rng(3)
    vind = rng.integers(0, 16, size=(64, 17)).astype(np.int32)
    vind[10:20] = vind[0]
    keys_j = jpar.pack_keys(jnp.asarray(vind), 4)
    keys_t = parallel.pack_keys(_t(vind), 4)
    for a, b in zip(keys_t, keys_j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jnp.lexsort(tuple(reversed(keys_j))))
    assert np.array_equal(parallel._lexsort(keys_t).numpy(), want)


# ---------------------------------------------------------------------------
# K3 marginal epilogue
# ---------------------------------------------------------------------------

def test_marginal_step_plain_matches_tnax():
    args = marginal_inputs(np.random.default_rng(0))
    Pn_j, mPn_j = jengine.marginal_step(*(jnp.asarray(a) for a in args))
    Pn, mPn = (x[0] for x in engine.marginal_step(
        *(_t(a)[None] for a in args[:-1]), torch.tensor([args[-1]])))
    np.testing.assert_allclose(Pn.numpy(), np.asarray(Pn_j), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(mPn.numpy(), np.asarray(mPn_j), rtol=1e-12,
                               atol=1e-15)
    assert (mPn.numpy() < 0).any() and (mPn.numpy() == -1.0).any()


def test_marginal_epilogue_plain_matches_tnax_probf():
    rng = np.random.default_rng(1)
    args = marginal_inputs(rng)
    M = args[3].shape[0]
    prob = -np.abs(rng.standard_normal(M)) * 40
    valid = rng.random(M) < 0.7
    Pn_j, mPn_j = jengine.marginal_step(*(jnp.asarray(a) for a in args))
    NEG = jpar.NEG
    logP = jnp.where(Pn_j > 0, jnp.log2(jnp.where(Pn_j > 0, Pn_j, 1.0)),
                     NEG)
    want = np.asarray(jnp.where(jnp.asarray(valid)[:, None],
                                jnp.asarray(prob)[:, None] + logP, NEG))
    lB, rest = args[0], args[1:-1]
    probf, mPn = (x[0] for x in engine.marginal_probf(
        kernels.marginal.boltzmann_columns(_t(lB)[None]),
        *(_t(a)[None] for a in rest), torch.tensor([args[-1]]),
        _t(prob)[None], _t(valid)[None], float(np.log2(1e-8)))[:2])
    np.testing.assert_allclose(probf.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(mPn.numpy(), np.asarray(mPn_j), rtol=1e-12,
                               atol=1e-15)
