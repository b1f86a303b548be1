"""Port parity of the Solver's noise, rotations, contraction context and
balancing preconditioner against tnax, in float64 on the CPU: couplings
bit for bit, cluster orders exactly, tensors and gauges to 1e-10, with
tnax's sketch matrices handed to the port's zip-up."""

import inspect

import numpy as np
import pytest
import torch

import tnax
import tnax_torch as tt
from tnax import parallel as jpar
from tnax import search as jsearch
from tnax_torch import interop
from test_search_small import make_chimera_like
from torch_helpers import dense, tnax_omega


def _pair(Nx=3, Ny=3, Nc=4, beta=2, seed=3):
    J = make_chimera_like(np.random.default_rng(seed), Nx, Ny, Nc)
    return (tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J),
            tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J,
                      device="cpu"))


def test_add_noise_gives_tnax_couplings_bit_for_bit():
    ins_j, ins = _pair()
    np.random.seed(7)
    ins_j.add_noise(1e-7)
    np.random.seed(7)
    ins.add_noise(1e-7)
    a, b = ins_j.problem.J.toarray(), ins.problem.J.toarray()
    assert np.array_equal(a, b)
    assert not np.array_equal(b, ins.J0.toarray())
    # the per-site tables follow the new couplings
    for ny in range(3):
        for nx in range(3):
            assert np.array_equal(ins.problem.site(ny, nx).Es,
                                  ins_j.problem.site(ny, nx).Es)


@pytest.mark.parametrize("rot", [0, 1, 2, 3, 5])
def test_rotate_graph_orders_match_tnax(rot):
    ins_j, ins = _pair(Nx=4, Ny=2)
    ins_j.rotate_graph(rot=rot)
    ins.rotate_graph(rot=rot)
    for k in ("order", "order_i"):
        assert np.array_equal(getattr(ins, k), getattr(ins_j, k)), k
    assert ins.rotation == ins_j.rotation
    assert (ins.Nx, ins.Ny) == (ins_j.Nx, ins_j.Ny)
    assert all(np.array_equal(a, b) for ra, rb in zip(ins.ind0, ins_j.ind0)
               for a, b in zip(ra, rb))
    assert np.array_equal(ins.problem.J.toarray(),
                          ins_j.problem.J.toarray())
    # a state in the rotated cluster order decodes to tnax's spins
    states = np.arange(8)[None] % 5
    ins.states = ins_j.states = states[:, ins.order]
    assert np.array_equal(ins.binary_states(), ins_j.binary_states())


@pytest.mark.parametrize("rsvd", [False, True])
def test_contraction_context_matches_tnax(rsvd, monkeypatch):
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    ins_j, ins = _pair()
    ctx_j = ins_j._context()
    ctx_j.build_boundary(8, 1e-16, 1e-10, 4, True, rsvd=rsvd)
    ctx = ins._context()
    ctx.build_boundary(8, 1e-16, 1e-10, 4, True, rsvd=rsvd,
                       omega=tnax_omega)
    assert ctx.B == 1 and ctx.rhoT.shape[0] == 1
    np.testing.assert_allclose(ctx.lB[0].numpy(), np.asarray(ctx_j.lB),
                               rtol=1e-10)
    np.testing.assert_allclose(ctx.Wt[0].numpy(), np.asarray(ctx_j.Wt),
                               rtol=1e-10)
    assert np.array_equal(ctx.drindex[0].numpy(),
                          np.asarray(ctx_j.drindex))
    # QR and SVD leave each boundary's gauge free: compare the states
    for ny in range(ctx.Ny + 1):
        a = dense(ctx.rhoT[0, ny].numpy(), 0.0)
        b = dense(np.asarray(ctx_j.rhoT[ny]), 0.0)
        a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
        assert np.linalg.norm(a - b) <= 1e-10, ny
    np.testing.assert_allclose(ctx.rhoT_overlap[0].numpy(),
                               ctx_j.rhoT_overlap, rtol=1e-10)
    # the discarded weight sqrt(|G|^2 - sum of kept s^2) / s0 cancels:
    # its rounding is about sqrt(eps) ~ 1.5e-8 absolute
    assert float(ctx.rhoT_discarded[0]) == pytest.approx(
        ctx_j.rhoT_discarded, abs=5e-8)
    for ny, nx in ((0, 0), (2, 1)):
        for a, b in zip(ctx.energy_tables(ny, nx),
                        ctx_j.energy_tables(ny, nx)):
            assert np.array_equal(a, b)


def test_context_takes_tnax_gauges_through_interop():
    ins_j, ins = _pair()
    g = ins_j._context().grid
    rng = np.random.default_rng(0)
    X = {k: np.exp(rng.uniform(-1, 1, v.shape))
         for k, v in tnax.engine.identity_gauges(g).items()}
    ctx_j = jsearch.ContractionContext(ins_j.problem, ins_j.beta, gauges=X)
    ctx = tt.search.ContractionContext(
        ins, gauges=interop.gauges(X, "cpu", torch.float64))
    np.testing.assert_allclose(ctx.lB[0].numpy(), np.asarray(ctx_j.lB),
                               rtol=1e-10)
    np.testing.assert_allclose(ctx.Wt[0].numpy(), np.asarray(ctx_j.Wt),
                               rtol=1e-10)


def test_precondition_matches_tnax_device_ladder(monkeypatch):
    """Two rungs at D=8 (Solver.precondition's defaults) after noise; tnax
    on its device ladder (its CPU default is the host sweeps)."""
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    ins_j, ins = _pair(Nx=3, Ny=4)
    for s in (ins_j, ins):
        np.random.seed(7)
        s.add_noise(1e-7)
    ins_j.precondition(path="device")
    ins.precondition(path="device", omega=tnax_omega)
    for k in ("Xl", "Xr", "Xu", "Xd"):
        np.testing.assert_allclose(ins._gauges[k][0].numpy(),
                                   ins_j._gauges[k], rtol=1e-10)
    assert not np.allclose(ins._gauges["Xd"][0].numpy(), 1.0)
    assert ins.overlaps_ud.shape == ins_j.overlaps_ud.shape == (4, 3)
    np.testing.assert_allclose(ins.overlaps_ud, ins_j.overlaps_ud,
                               rtol=1e-8)
    # the next context is built on the balanced gauges
    np.testing.assert_allclose(ins._context().lB[0].numpy(),
                               np.asarray(ins_j._context().lB), rtol=1e-10)


def test_unported_paths_raise(monkeypatch):
    """No path of tnax's preconditioner is left unported: the host sweeps
    and the 'lr' direction on either path give tnax's gauges; a path
    that neither package has is a ValueError."""
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    for path, directions in (("host", ("ud",)), ("device", ("ud", "lr"))):
        ins_j, ins = _pair()
        ins_j.precondition(path=path, directions=directions)
        ins.precondition(path=path, directions=directions, omega=tnax_omega)
        for k in ("Xl", "Xr", "Xu", "Xd"):
            np.testing.assert_allclose(ins._gauges[k][0].numpy(),
                                       ins_j._gauges[k], rtol=1e-10)
        np.testing.assert_allclose(ins.overlaps_ud, ins_j.overlaps_ud,
                                   rtol=1e-10)
    with pytest.raises(ValueError, match="path"):
        ins.precondition(path="gpu")


SMALL = dict(M=16, Dmax=4, pre_Dmax=4, cand_factor=2)


@pytest.mark.parametrize("name", ["flagship_search_gs",
                                  "multi_flagship_search_gs",
                                  "flagship_sample", "multi_flagship_sample"])
def test_entry_points_take_tnax_keywords(name):
    """Every keyword of tnax's entry point, at tnax's defaults (a few
    shrunk), is accepted."""
    _, ins = _pair(Nx=2, Ny=2)
    params = list(inspect.signature(getattr(jpar, name)).parameters.values())
    kw = {p.name: p.default for p in params[1:]}
    kw.update({k: v for k, v in SMALL.items() if k in kw})
    arg = [ins] if name.startswith("multi") else ins
    out = getattr(tt.parallel, name)(arg, **kw)
    assert len(out[0] if name.startswith("multi") else out) > 0


def test_sampler_takes_seed_after_graduate_truncation():
    _, ins = _pair(Nx=2, Ny=2, beta=0.2)
    pos = tt.flagship_sample(ins, 16, 4, 1e-15, 1e-10, 20, True, 3,
                             pre_Dmax=4)
    kw = tt.flagship_sample(ins, M=16, Dmax=4, seed=3, pre_Dmax=4)
    other = tt.flagship_sample(ins, M=16, Dmax=4, seed=4, pre_Dmax=4)
    assert np.array_equal(pos["states"], kw["states"])
    assert not np.array_equal(pos["states"], other["states"])


@pytest.mark.parametrize("select,ok", [("topk", True), ("sort", True),
                                       ("radix", False), ("compact", False)])
def test_select_modes(select, ok):
    _, ins = _pair(Nx=2, Ny=2)
    kw = dict(M=16, Dmax=4, pre_Dmax=4, select=select)
    if ok:
        r = tt.parallel.flagship_search_gs(ins, **kw)
        want = tt.parallel.flagship_search_gs(ins, M=16, Dmax=4, pre_Dmax=4)
        assert np.array_equal(r.pop("states"), want.pop("states"))
        assert r == want
    else:
        with pytest.raises(ValueError):
            tt.parallel.flagship_search_gs(ins, **kw)


@pytest.mark.parametrize("rsvd", ["bf16", "wide", 1, "yes"])
def test_unknown_sketches_raise(rsvd):
    _, ins = _pair(Nx=2, Ny=2)
    with pytest.raises(ValueError):
        tt.parallel.flagship_search_gs(ins, M=16, Dmax=4, pre_Dmax=4,
                                       zipup_rsvd=rsvd)
    with pytest.raises(ValueError):
        ins._context().build_boundary(4, 1e-16, 1e-10, 2, rsvd=rsvd)
