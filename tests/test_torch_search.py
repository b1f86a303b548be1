"""Port parity of the beam search and the whole flagship slice against
tnax, in float64 on the CPU: one beam row started from tnax's own beam
state, and flagship_search_gs end to end on a 3x3 lattice of 4-spin
blocks, with tnax's sketch matrices handed to the port."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import engine as jengine
from tnax import parallel as jpar
import tnax_torch as tt
from tnax_torch import engine, interop, parallel
from tnax_torch.kernels import marginal
from test_search_small import make_chimera_like
from torch_helpers import tnax_omega

M = 64


def _rows(seed=11, Nx=3, Ny=3, Nc=4, beta=2.0, D=8):
    """tnax tensors of a small search: row tables, rhoT, Wt, a beam."""
    rng = np.random.default_rng(seed)
    J = make_chimera_like(rng, Nx, Ny, Nc)
    ins = tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J)
    g = jengine.pad_grid(ins.problem)
    X = jengine.identity_gauges(g)
    lB, Wt = jengine.peps_rows(
        *(jnp.asarray(a) for a in (g.Es, g.Esl, g.Esu, g.dmap, g.rmap,
                                   X["Xl"], X["Xr"], X["Xu"], X["Xd"])),
        beta, lh=g.lh, lv=g.lv)
    rhoT = jengine.build_rhoT(Wt, Dmax=D, tolS=1e-16, tolV=1e-10,
                              max_sweeps=4, graduate=False, rsvd=False)[0]
    EsR, EslR, EsuR = jpar._padded_energy_rows_problem(ins.problem,
                                                       jnp.float64)
    drindex = (g.dmap * g.lh + g.rmap).astype(np.int32)
    cols = np.arange(Ny)[:, None] * Nx + np.arange(Nx)[None, :]
    rows = dict(lB=lB, drindex=drindex, Es=EsR, Esl=EslR, Esu=EsuR,
                dmap=g.dmap, rmap=g.rmap, nvalid=g.nstates, cols=cols)
    return g, rows, rhoT, Wt


def _tnax_row(beam, rows, rhoT, Wt, ny, g, bits):
    D = rhoT.shape[2]
    beam = dict(beam, aidx=jnp.arange(M, dtype=jnp.int32),
                RL=jnp.zeros((M, D)).at[:, 0].set(1.0))
    RRs = jengine.row_right_envs(rhoT[ny + 1], Wt[ny], beam["vind"][:, 1:])
    row = {k: jnp.asarray(v[ny]) for k, v in rows.items()}
    row.update(AT=rhoT[ny + 1], RRs=RRs)
    return jpar.row_step(beam, row, M=M, Nx=g.Nx, bits=bits, min_dEng=1e-12,
                         log2_cutoff=float(np.log2(1e-10)), cand=8 * M)


def test_row_step_from_tnax_beam_matches_tnax():
    g, rows, rhoT, Wt = _rows()
    bits = 4
    D = rhoT.shape[2]
    beam0 = dict(
        RL=jnp.zeros((M, D)).at[:, 0].set(1.0),
        vind=jnp.zeros((M, g.Nx + 1), jnp.int32),
        states=jnp.zeros((M, g.Nx * g.Ny), jnp.int32),
        Eng=jnp.zeros((M,)), prob=jnp.full((M,), jpar.NEG).at[0].set(0.0),
        deg=jpar.deg_ones((M,)), valid=jnp.zeros((M,), bool).at[0].set(True),
        aidx=jnp.arange(M, dtype=jnp.int32))
    beam1, _ = _tnax_row(beam0, rows, rhoT, Wt, 0, g, bits)
    want, aux_want = _tnax_row(beam1, rows, rhoT, Wt, 1, g, bits)

    # the port takes over tnax's beam after row 0 and runs row 1, as a
    # batch of one instance
    beam = interop.beam({k: np.asarray(v) for k, v in beam1.items()}, "cpu",
                        torch.float64)
    beam["aidx"] = torch.arange(M)[None]
    beam["RL"] = torch.zeros((1, M, D), dtype=torch.float64)
    beam["RL"][:, :, 0] = 1.0
    rhoT_t = torch.as_tensor(np.array(rhoT))[None]
    Wt_t = torch.as_tensor(np.array(Wt))[None]
    RRs = engine.row_right_envs(rhoT_t[:, 2], Wt_t[:, 1],
                                beam["vind"][:, :, 1:])
    RRs_j = jengine.row_right_envs(rhoT[2], Wt[1], beam1["vind"][:, 1:])
    np.testing.assert_allclose(RRs[0].numpy(), np.asarray(RRs_j), rtol=1e-10,
                               atol=1e-14)
    row = {k: torch.as_tensor(np.array(v[1]))[None] for k, v in rows.items()
           if k != "cols"}
    row.update(cols=rows["cols"][1].tolist(), AT=rhoT_t[:, 2], RRs=RRs,
               lBT=marginal.boltzmann_columns(row.pop("lB")))
    got, aux = parallel.row_step(beam, row, M=M, Nx=g.Nx, bits=bits,
                                 min_dEng=1e-12,
                                 log2_cutoff=float(np.log2(1e-10)),
                                 cand=8 * M)
    got = {k: v[0] for k, v in got.items()}
    for k in ("vind", "states", "valid"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(got["deg"].numpy(),
                          interop.deg_decode(want["deg"]))
    valid = got["valid"].numpy()
    for k in ("Eng", "prob"):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=1e-10)
    np.testing.assert_allclose(got["RL"].numpy()[valid],
                               np.asarray(want["RL"])[valid], rtol=1e-8,
                               atol=1e-12)
    for k in ("ovf", "cmax"):
        assert int(aux[k]) == int(aux_want[k]), k
    for k in ("mq", "mqc", "pd"):
        assert float(aux[k]) == pytest.approx(float(aux_want[k]), rel=1e-8,
                                              abs=1e-12), k


def _recheck(J, ins, states):
    ins.states = np.asarray(states)[None, :][:, ins.order]
    return float(tnax.energy_Jij(J, ins.binary_states())[0])


@pytest.mark.parametrize("rsvd", [False, True])
def test_flagship_matches_tnax(rsvd, monkeypatch):
    # tnax's flagship ladder reads the ambient sketch default; the port's
    # ladder always sketches
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    rng = np.random.default_rng(17)
    Nx = Ny = 3
    Nc = 4
    J = make_chimera_like(rng, Nx, Ny, Nc)
    ins_j = tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=2, J=J)
    want = jpar.flagship_search_gs(ins_j, M=M, relative_P_cutoff=1e-10,
                                   Dmax=8, zipup_rsvd=rsvd)
    ins = tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=2, J=J,
                    device="cpu")
    got = tt.parallel.flagship_search_gs(ins, M=M, relative_P_cutoff=1e-10,
                                         Dmax=8, zipup_rsvd=rsvd,
                                         omega=tnax_omega)
    assert np.array_equal(got["states"], np.asarray(want["states"]))
    assert got["degeneracy"] == want["degeneracy"]
    E = _recheck(J, ins, got["states"])
    assert E == pytest.approx(_recheck(J, ins_j, want["states"]), abs=1e-9)
    assert got["energy"] == pytest.approx(E, abs=1e-9)
    assert got["merge_overflow"] == want["merge_overflow"]
    assert got["count_max"] == want["count_max"]
    assert got["discarded_probability"] == pytest.approx(
        want["discarded_probability"], rel=1e-6)

