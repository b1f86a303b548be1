"""The uncapped exact merge and the epilogue's reductions against tnax, in
float64 on the CPU: ``flagship_search_gs(cand_factor=None)`` end to end on
a lattice where tnax's default cap of 8 * M overflows, the key1 merge of
two instances of C = 16,384 > 8192 candidates, and the per-instance
reductions (pmax, mq, mqc) that the marginal epilogue (K3) now returns.
Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import engine as jengine
from tnax import parallel as jpar
import tnax_torch as tt
from tnax_torch import engine, interop, kernels, parallel
from test_search_small import make_chimera_like
from torch_helpers import (candidate_key1, candidate_set, marginal_inputs,
                           tnax_omega)

NEG = jpar.NEG


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_flagship_full_expansion_matches_tnax(monkeypatch):
    # tnax's flagship ladder reads the ambient sketch default; the port's
    # ladder always sketches
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    rng = np.random.default_rng(17)
    Nx = Ny = 3
    Nc, M = 4, 4
    J = make_chimera_like(rng, Nx, Ny, Nc)
    kw = dict(M=M, relative_P_cutoff=1e-10, Dmax=8, cand_factor=None)
    want = jpar.flagship_search_gs(
        tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=2, J=J), **kw)
    # more candidates pass the cutoff at some site than tnax's default
    # cap of 8 * M holds: only the full expansion merges them all
    assert want["count_max"] > 8 * M
    ins = tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=2, J=J,
                    device="cpu")
    got = tt.parallel.flagship_search_gs(ins, omega=tnax_omega, **kw)
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    assert got["degeneracy"] == want["degeneracy"]
    assert got["merge_overflow"] == want["merge_overflow"] == 0
    assert got["count_max"] == want["count_max"]
    # the port's float64 beam energy is the exact energy of its state;
    # tnax's beam energy differs from it by its own rounding
    ins.states = np.asarray(got["states"])[None, :][:, ins.order]
    E = float(tt.energy_Jij(J, ins.binary_states())[0])
    assert got["energy"] == pytest.approx(E, abs=1e-9)
    assert got["energy"] == pytest.approx(float(want["energy"]), abs=1e-4)


def test_merge_candidates_key1_above_8192_matches_tnax():
    """Two instances of C = 16,384 candidates in one batched merge, each
    equal to tnax's merge of it alone; the keys are ranks of the vind rows
    (below 2 * C = 2**15), so the kernel would sort 15 bits."""
    rng = np.random.default_rng(4)
    M, C, Nx, bits = 1024, 16384, 4, 4
    sets = [candidate_set(rng, M, C, Nx, bits) for _ in range(2)]
    key1 = np.stack([candidate_key1(v, ok) for v, _, _, ok, _ in sets])
    assert 0 <= key1.min() and key1.max() < 2 ** 15
    vind, Eng, prob, valid, deg = (_t(np.stack(x)) for x in zip(*sets))
    got = parallel.merge_candidates(vind, Eng, prob, valid, 1e-12, bits, M,
                                    deg, key1=_t(key1), key_bits=15)
    for b, (v, E, p, ok, d) in enumerate(sets):
        ref = jpar.merge_candidates(
            jnp.asarray(v), jnp.asarray(E), jnp.asarray(p), jnp.asarray(ok),
            1e-12, bits, M, deg=jnp.asarray(jpar.deg_encode(d)),
            key1=jnp.asarray(key1[b]))
        slot, rep, prob_out, Eng_out, out_valid, disc, deg_out = (
            x[b] for x in got)
        assert np.array_equal(slot.numpy(), np.asarray(ref[0]))
        assert np.array_equal(rep.numpy(), np.asarray(ref[1]))
        assert np.array_equal(out_valid.numpy(), np.asarray(ref[4]))
        assert np.array_equal(Eng_out.numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(prob_out.numpy(), np.asarray(ref[2]),
                                   rtol=1e-12)
        assert float(disc) == pytest.approx(float(ref[5]), rel=1e-12)
        assert np.array_equal(deg_out.numpy(), interop.deg_decode(ref[6]))


def _epilogue_args(rng, nvalids, M=48):
    ins = [marginal_inputs(rng, M=M, nvalid=nv) for nv in nvalids]
    lB, drindex, AT, RL, RRsel, lidx, uidx = (
        _t(np.stack(x)) for x in list(zip(*ins))[:7])
    B = len(nvalids)
    prob = -np.abs(rng.standard_normal((B, M))) * 40
    valid = rng.random((B, M)) < 0.7
    return (lB, drindex, AT, RL, RRsel, lidx, uidx, np.array(nvalids), prob,
            valid)


@pytest.mark.parametrize("nvalids", [[13], [13, 16, 9]], ids=["B1", "B3"])
def test_epilogue_reductions_match_row_step_and_tnax(nvalids):
    args = _epilogue_args(np.random.default_rng(8), nvalids)
    lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid, prob, valid = args
    log2_cutoff = -30.0
    B = len(nvalids)
    T2 = engine._marginal_T2(AT, RL, RRsel)
    ins = (T2, kernels.marginal.boltzmann_columns(lB), drindex, lidx, uidx,
           _t(nvalid), _t(prob), _t(valid))
    probf, mPn, pmax, mq, mqc = kernels.marginal_epilogue(*ins, log2_cutoff)
    assert (mPn < 0).any() and (mq < 0).any()
    # the reductions row_step took of probf and mPn before K3 took them
    pv, vv = _t(prob), _t(valid)
    assert torch.equal(pmax, probf.reshape(B, -1).amax(dim=1))
    assert torch.equal(mq, torch.where(vv, mPn, 0.0).amin(dim=1))
    bmax = torch.where(vv, pv, NEG).amax(dim=1, keepdim=True)
    core = vv & (pv > bmax + log2_cutoff)
    assert core.any() and not core.equal(vv)
    assert torch.equal(mqc, torch.where(core, mPn, 0.0).amin(dim=1))
    for b in range(B):
        # tnax's (parallel.py row_step), instance by instance
        Pn_j, mPn_j = jengine.marginal_step(
            *(jnp.asarray(a[b]) for a in (lB, drindex, AT, RL, RRsel, lidx,
                                          uidx)), jnp.asarray(nvalid[b]))
        logP = jnp.where(Pn_j > 0, jnp.log2(jnp.where(Pn_j > 0, Pn_j, 1.0)),
                         NEG)
        v, p = jnp.asarray(valid[b]), jnp.asarray(prob[b])
        probf_j = jnp.where(v[:, None], p[:, None] + logP, NEG)
        bmax_j = jnp.max(jnp.where(v, p, NEG))
        core_j = v & (p > bmax_j + log2_cutoff)
        for x, y in ((pmax, jnp.max(probf_j)),
                     (mq, jnp.min(jnp.where(v, mPn_j, 0.0))),
                     (mqc, jnp.min(jnp.where(core_j, mPn_j, 0.0)))):
            assert float(x[b]) == pytest.approx(float(y), rel=1e-12,
                                                abs=1e-15)
        # and the batched call equals the call of the instance alone
        one = kernels.marginal_epilogue_plain(
            *(a[b:b + 1] for a in ins), log2_cutoff)
        for x, y in zip((probf, mPn, pmax, mq, mqc), one):
            assert torch.equal(x[b], y[0])
