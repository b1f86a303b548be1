"""Port parity of the balancing ladder (tnax_torch.precondition) against
tnax's device ladder, in float64 on the CPU, with tnax's sketch matrices
handed to the port's zip-up."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tnax
from tnax import engine as jengine
from tnax import precondition as jpre
from tnax_torch import interop, precondition
from test_search_small import make_chimera_like
from torch_helpers import tnax_omega


@pytest.mark.parametrize("betas", [[1.0], [0.5, 1.0]])
def test_ladder_program_gauges_match_tnax(betas, monkeypatch):
    # tnax's ladder zips up with the sketch unless TNAX_ZIPUP_RSVD=0
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "1")
    rng = np.random.default_rng(7)
    Nx, Ny, Nc = 3, 4, 4
    J = make_chimera_like(rng, Nx, Ny, Nc)
    ins = tnax.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=2, J=J)
    g = jengine.pad_grid(ins.problem)
    X0 = jengine.identity_gauges(g)
    nd = np.asarray(ins.problem.ld[:Ny - 1], np.int32)
    tabs = (g.Es, g.Esl, g.Esu, g.dmap, g.rmap)
    kw = dict(Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20, lh=g.lh,
              lv=g.lv)
    X_j, ov_j = jpre._ladder_program(
        *(jnp.asarray(a) for a in tabs), {k: jnp.asarray(v) for k, v in
                                          X0.items()},
        jnp.asarray(betas), jnp.asarray(nd), jnp.asarray(32.0),
        graduate=False, **kw)
    # the port's ladder takes a leading instance axis: a batch of one
    X_t, ov_t = precondition._ladder_program(
        *(torch.as_tensor(a)[None] for a in tabs),
        interop.gauges(X0, "cpu", torch.float64), betas,
        torch.as_tensor(nd)[None], 32.0, omega=tnax_omega, **kw)
    for k in ("Xl", "Xr", "Xu", "Xd"):
        np.testing.assert_allclose(X_t[k][0].numpy(), np.asarray(X_j[k]),
                                   rtol=1e-12)
    assert not np.array_equal(X_t["Xd"][0].numpy(), X0["Xd"])
    np.testing.assert_allclose(ov_t[0].numpy(), np.asarray(ov_j), rtol=1e-8)


def test_balance_one_interface_matches_tnax():
    """The interface sweeps alone, on random boundary rows with a ragged
    vertical leg, batched over three interfaces."""
    rng = np.random.default_rng(3)
    Ni, Nx, D, lv = 3, 4, 5, 6
    B = rng.standard_normal((Ni, Nx, D, lv, D))
    T = rng.standard_normal((Ni, Nx, D, lv, D))
    nd = rng.integers(3, lv + 1, size=(Ni, Nx)).astype(np.int32)
    outs_t = precondition._balance_one_interface(
        torch.as_tensor(B), torch.as_tensor(T), torch.as_tensor(nd), 32.0)
    for i in range(Ni):
        outs_j = jpre._balance_one_interface(
            jnp.asarray(B[i]), jnp.asarray(T[i]), jnp.asarray(nd[i]),
            jnp.asarray(32.0))
        for a, b in zip(outs_t, outs_j):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b),
                                       rtol=1e-10)
