"""The port's kernels against their plain PyTorch versions on a CUDA
card, at the flagship shapes, in float32 and float64. Marked ``gpu`` and
skipped without a card. This file imports neither jax nor tnax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py configures jax).
"""

import numpy as np
import pytest
import torch

from tnax_torch import engine, kernels


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _badly_scaled(rng, n):
    A = rng.standard_normal((n, n))
    return A * np.exp2(rng.integers(-20, 20, size=(n, 1)))


def _candidates(rng, M, C, Nx, bits):
    """A merge candidate set with repeated vind rows, energy ties within
    min_dEng and exact probability ties; int64 degeneracies."""
    parents = rng.integers(0, 1 << bits, size=(M // 4, Nx + 1))
    vind = parents[rng.integers(0, M // 4, size=C)].astype(np.int32)
    Eng = rng.integers(-40, 40, size=C) / 4.0
    prob = -rng.integers(0, 30, size=C) / 8.0
    valid = rng.random(C) < 0.85
    deg = rng.integers(1, 1 << 24, size=C)
    return vind, Eng, prob, valid, deg


def _key1(vind, valid):
    """An injective int32 key of (vind row, validity): the row's rank."""
    _, rank = np.unique(vind, axis=0, return_inverse=True)
    return ((rank.reshape(-1).astype(np.int32) << 1)
            | (~valid).astype(np.int32))


def _marginal_inputs(rng, M=48, Np=16, lh=4, lv=4, D=6, nvalid=13):
    lB = -np.abs(rng.standard_normal((Np, lh, lv))) * 30
    lB[nvalid:] = -np.inf
    lB[:, 3, :] = -np.inf          # a leg value with no allowed state
    drindex = rng.permutation(lh * lv)[:Np].astype(np.int32)
    AT = rng.standard_normal((D, lv, D))
    RL = rng.standard_normal((M, D))
    RRsel = np.abs(rng.standard_normal((M, D, lh)))
    RRsel[::5] -= 0.3              # negative marginals to clamp
    lidx = rng.integers(0, lh, size=M).astype(np.int32)
    uidx = rng.integers(0, lv, size=M).astype(np.int32)
    return lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid


def _rtol(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gebal_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    A = _t(np.stack([_badly_scaled(rng, 16) for _ in range(15)]))
    A = A.to(cuda, dtype)
    nd = torch.tensor([16] * 14 + [9], device=cuda)
    before = kernels.gebal_scale.launches
    got = kernels.gebal_scale(A, nd, 32.0)
    assert kernels.gebal_scale.launches == before + 1
    assert torch.equal(got, kernels.gebal_scale_plain(A, nd, 32.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    vind, Eng, prob, valid, deg = _candidates(rng, 1024, 8192, 16, 4)
    args = (_t(_key1(vind, valid)).to(cuda), _t(Eng).to(cuda),
            _t(prob).to(cuda, dtype), _t(valid).to(cuda), _t(deg).to(cuda))
    got = kernels.merge_segments(*args, 1e-12)
    want = kernels.merge_segments_plain(*args, 1e-12)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[4], want[4], rtol=_rtol(dtype),
                               atol=_rtol(dtype))


@pytest.mark.gpu
def test_merge_kernel_refuses_oversized_sets(cuda):
    C = kernels.merge.C_MAX + 1
    args = (torch.zeros(C, dtype=torch.int32, device=cuda),
            torch.zeros(C, dtype=torch.float64, device=cuda),
            torch.zeros(C, dtype=torch.float64, device=cuda),
            torch.ones(C, dtype=torch.bool, device=cuda),
            torch.ones(C, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        kernels.merge_segments(*args, 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_marginal_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    lB, drindex, AT, RL, RRsel, lidx, uidx, nvalid = _marginal_inputs(
        rng, M=1024, Np=256, lh=16, lv=16, D=32, nvalid=200)
    T2 = engine._marginal_T2(*(_t(a).to(cuda, dtype)
                               for a in (AT, RL, RRsel)))
    args = (T2, _t(lB).to(cuda, dtype), _t(drindex).to(cuda),
            _t(lidx).to(cuda), _t(uidx).to(cuda), nvalid,
            _t(-np.abs(rng.standard_normal(1024)) * 40).to(cuda, dtype),
            _t(rng.random(1024) < 0.7).to(cuda))
    got = kernels.marginal_epilogue(*args)
    want = kernels.marginal_epilogue_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=_rtol(dtype), atol=_rtol(dtype))


@pytest.mark.gpu
def test_search_loop_never_syncs(cuda):
    """The beam search over all rows reads nothing back to the host:
    with CUDA sync debugging set to error, any synchronizing call in
    full_search_scan raises."""
    import os
    import tnax_torch as tt
    from tnax_torch import parallel
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera128_synth_s0.txt")
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float32)
    g = engine.pad_grid(ins.problem)
    X = {k: _t(v).to(cuda, torch.float32)
         for k, v in engine.identity_gauges(g).items()}
    f32 = [_t(a).to(cuda, torch.float32) for a in (g.Es, g.Esl, g.Esu)]
    dmap, rmap = _t(g.dmap).to(cuda), _t(g.rmap).to(cuda)
    lB, Wt = engine.peps_rows(*f32, dmap, rmap, X["Xl"], X["Xr"], X["Xu"],
                              X["Xd"], 3.0, lh=g.lh, lv=g.lv)
    M, D = 256, 16
    rhoT = engine.build_rhoT(Wt, Dmax=D, tolS=1e-16, tolV=1e-10,
                             max_sweeps=2)[0]
    raw = [_t(a).to(cuda, torch.float64)
           for a in parallel._padded_energy_rows_problem(ins.problem)]
    cols = (np.arange(4)[:, None] * 4 + np.arange(4)[None, :]).tolist()
    grid_in = dict(lB=lB, drindex=dmap.long() * g.lh + rmap.long(),
                   Es=raw[0], Esl=raw[1], Esu=raw[2], dmap=dmap, rmap=rmap,
                   nvalid=g.nstates.tolist(), cols=cols)
    beam0 = parallel._initial_beam(M, D, 4, 4, torch.float32, cuda)
    kw = dict(M=M, Nx=4, bits=4, min_dEng=1e-12,
              log2_cutoff=float(np.log2(1e-8)), cand=8 * M)
    parallel.full_search_scan(beam0, grid_in, rhoT, Wt, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        beam, aux = parallel.full_search_scan(beam0, grid_in, rhoT, Wt, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(beam["valid"].any())
