"""Port parity of the spectrum's per-site decision records
(tnax_torch.parallel.row_records_prog) against tnax's row_records_prog,
in float64 on the CPU, field by field: the integer fields exactly, the
float32 fields as bits. A 3x3 lattice of 5-spin blocks (Np = 32) at
M = 64, with a boundary bond (D = 32) at which the stack is exact, so no
marginal saturates into ties that rounding would order, and three
candidate-cap regimes: the prob-ordered top C with
overflow, tnax's compact order below the full expansion with a pull cap
P < C, and the full expansion with P = C. Both packages contract the same
boundary stack (tnax's), so the records test the search's decisions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import parallel as jpar
from tnax import search as jsearch
from tnax import spectrum as jspec
import tnax_torch as tt
from tnax_torch import spectrum
from test_search_small import make_chimera_like
import torch_helpers  # noqa: F401  (the thread policy)

M, D, CUTOFF = 64, 32, 1e-16
INT_FIELDS = ("src", "indc", "slot", "rep", "out_valid", "n_valid", "count")
F32_FIELDS = ("cprob", "out_prob", "disc_cut", "disc_m", "minP",
              "minP_core")


def _unpack_tnax(rec, P):
    """tnax's packed int32 record (Nx, 4P+3M+6) as fields (Nx, ...)."""
    f32 = lambda a: a.view(np.float32)   # noqa: E731
    return dict(src=rec[:, :P], indc=rec[:, P:2 * P],
                slot=rec[:, 2 * P:3 * P], rep=rec[:, 3 * P:3 * P + M],
                cprob=f32(rec[:, 3 * P + M:4 * P + M]),
                out_prob=f32(rec[:, 4 * P + M:4 * P + 2 * M]),
                out_valid=rec[:, 4 * P + 2 * M:4 * P + 3 * M].astype(bool),
                n_valid=rec[:, -6], count=rec[:, -5],
                disc_cut=f32(rec[:, -4]), disc_m=f32(rec[:, -3]),
                minP=f32(rec[:, -2]), minP_core=f32(rec[:, -1]))


@pytest.fixture(scope="module")
def lattice():
    rng = np.random.default_rng(5)
    Nx = Ny = 3
    J = make_chimera_like(rng, Nx, Ny, 5)
    ins_j = tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=5, beta=2, J=J)
    ctx_j = jsearch.ContractionContext(ins_j.problem, 2.0,
                                       dtype=jnp.float64)
    ctx_j.build_boundary(D, 1e-16, 1e-10, 4, False, rsvd=True)
    ins = tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=5, beta=2, J=J,
                    device="cpu")
    ctx = ins._context()
    # the port contracts tnax's stack (QR and SVD leave its gauge free)
    ctx.rhoT = torch.as_tensor(np.array(ctx_j.rhoT))[None]
    ctx.Dmax = D
    return ctx_j, ctx


def _tnax_rows(ctx_j, C, P):
    bits = max(1, int(np.ceil(np.log2(max(ctx_j.lh, ctx_j.lv)))))
    EsP, EslP, EsuP = jpar._padded_energy_rows(ctx_j)
    nvalid = jnp.asarray(ctx_j.nstates, jnp.int32)
    Nx = ctx_j.Nx
    beam = dict(vind=jnp.zeros((M, Nx + 1), jnp.int32),
                Eng=jnp.zeros((M,), jnp.float64),
                prob=jnp.full((M,), jpar.NEG).at[0].set(0.0),
                valid=jnp.zeros((M,), bool).at[0].set(True))
    out = []
    for ny in range(ctx_j.Ny):
        tabs = dict(lB=ctx_j.lB[ny], drindex=ctx_j.drindex[ny], Es=EsP[ny],
                    Esl=EslP[ny], Esu=EsuP[ny],
                    dmap=jnp.asarray(ctx_j.dmap[ny]),
                    rmap=jnp.asarray(ctx_j.rmap[ny]), nvalid=nvalid[ny])
        beam, rec = jpar.row_records_prog(
            beam, tabs, ctx_j.rhoT[ny + 1], ctx_j.Wt[ny], M=M, C=C, Nx=Nx,
            bits=bits, min_dEng=1e-12, log2_cutoff=float(np.log2(CUTOFF)),
            P=P, select=jspec._records_select(C, M))
        out.append(_unpack_tnax(np.asarray(rec), P))
    return out


@pytest.mark.parametrize("cand_factor,order", [
    (2, "topk"), (24, "compact"), (None, "compact")],
    ids=["topk-overflow", "compact-P<C", "full"])
def test_records_match_tnax(lattice, cand_factor, order):
    ctx_j, ctx = lattice
    C, P = spectrum.caps(M, ctx.Np, cand_factor)
    assert spectrum.records_select(C, M) == order
    assert jspec._records_select(C, M) == order
    if cand_factor == 24:
        assert C < M * ctx.Np and P < C
    if cand_factor is None:
        assert P == C == M * ctx.Np
    want = _tnax_rows(ctx_j, C, P)
    layout, rows = spectrum.dispatch_records(ctx, M=M, C=C, P=P,
                                             relative_P_cutoff=CUTOFF,
                                             min_dEng=1e-12)
    overflow = 0
    for ny, w in enumerate(want):
        # no marginal saturates into a uniform row, whose equal
        # probabilities each package would order by its own rounding
        assert (w["minP"] > -0.5).all(), (ny, w["minP"])
        got = spectrum._row_records(rows[ny], layout, 0)
        for k in INT_FIELDS:
            assert np.array_equal(got[k].astype(np.int64),
                                  w[k].astype(np.int64)), (ny, k)
        for k in F32_FIELDS:
            assert got[k].dtype == np.float32
            assert np.array_equal(got[k].view(np.int32),
                                  w[k].view(np.int32)), (ny, k)
        overflow += int(((got["count"] > C) | (got["n_valid"] > P)).sum())
    if cand_factor == 2:
        assert overflow > 0
    else:
        assert overflow == 0


def test_record_layout_views():
    """A row buffer's typed views cover disjoint, 8-byte aligned ranges
    inside the buffer."""
    nbytes, fields = tt.parallel.record_layout(2, 3, 5, 7)
    views = tt.parallel.record_views(
        torch.zeros(nbytes, dtype=torch.uint8), (nbytes, fields))
    end = 0
    for name, dt, shape, off in fields:
        assert off % 8 == 0 and off >= end
        assert views[name].dtype == dt and tuple(views[name].shape) == shape
        end = off + int(np.prod(shape)) * dt.itemsize
    assert end <= nbytes
