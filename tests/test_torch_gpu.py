"""The port's kernels against their plain PyTorch versions on a CUDA
card, at the flagship shapes and batched at the fleet's, in float32 and
float64 (K1 also at n = 9, 16, 17, 32 and on an extreme case, K2 up to
the full expansion, K4 at the sampler's shapes). Marked ``gpu`` and
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
from torch_helpers import (badly_scaled, candidate_key1, candidate_set,
                           extreme_gebal, marginal_inputs)


def _t(a):
    return torch.as_tensor(np.asarray(a))


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
    A = _t(np.stack([badly_scaled(rng, 16) for _ in range(15)]))
    A = A.to(cuda, dtype)
    nd = torch.tensor([16] * 14 + [9], device=cuda)
    before = kernels.gebal_scale.launches
    got = kernels.gebal_scale(A, nd, 32.0)
    assert kernels.gebal_scale.launches == before + 1
    assert torch.equal(got, kernels.gebal_scale_plain(A, nd, 32.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 16, 17, 32])
@pytest.mark.parametrize("case", ["badly_scaled", "extreme"])
def test_gebal_kernel_any_size_matches_plain(cuda, dtype, n, case):
    """K1 at n <= 16 (two matrices per warp) and 17..32 (one), on 15
    badly scaled matrices with one nd < n and on the extreme case, nd as
    int64 and as a strided int32 column: the plain version's scales bit
    for bit."""
    rng = np.random.default_rng(n)
    if case == "extreme":
        As, nds = extreme_gebal(rng, n)
    else:
        As = np.stack([badly_scaled(rng, n) for _ in range(15)])
        nds = np.array([n] * 14 + [n - 4])
    A = _t(As).to(cuda, dtype)
    want = kernels.gebal_scale_plain(A, _t(nds).to(cuda), 1e30)
    for nd in (_t(nds).to(cuda),
               _t(np.stack([nds, nds]).T).to(cuda, torch.int32)[:, 1]):
        assert torch.equal(kernels.gebal_scale(A, nd, 1e30), want)
    # a batch given transposed (non-contiguous matrices) and clipped
    At = A.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(kernels.gebal_scale(At, _t(nds).to(cuda), 32.0),
                       kernels.gebal_scale_plain(A, _t(nds).to(cuda), 32.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    vind, Eng, prob, valid, deg = candidate_set(rng, 1024, 8192, 16, 4)
    args = (_t(candidate_key1(vind, valid)).to(cuda), _t(Eng).to(cuda),
            _t(prob).to(cuda, dtype), _t(valid).to(cuda), _t(deg).to(cuda))
    got = kernels.merge_segments(*args, 1e-12)
    want = kernels.merge_segments_plain(*args, 1e-12)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[4], want[4], rtol=_rtol(dtype),
                               atol=_rtol(dtype))


def _keyed_set(rng, B, C, kb, dtype, cuda):
    """B rows of C candidates with keys in [0, 2**kb): about C / 4 groups
    of random size per row, the largest key 2**kb - 1 in every row; energy
    ties within groups, 10% invalid, degeneracies up to 2**40."""
    groups = rng.integers(0, 2 ** kb - 1, size=(B, max(1, C // 4)))
    key1 = np.take_along_axis(groups, rng.integers(0, groups.shape[1],
                                                   size=(B, C)), axis=1)
    key1[:, rng.integers(0, C, size=max(1, C // 64))] = 2 ** kb - 1
    return (_t(key1.astype(np.int32)).to(cuda),
            _t(rng.integers(-300, 300, size=(B, C)) / 75.0).to(cuda),
            _t(-np.abs(rng.standard_normal((B, C))) * 20).to(cuda, dtype),
            _t(rng.random((B, C)) < 0.9).to(cuda),
            _t(rng.integers(1, 2 ** 40, size=(B, C))).to(cuda))


def _gprob_rtol(seg, dtype):
    """gprob's tolerance: the kernel adds a group's n near members in
    another order than the plain version, so the two sums of n terms of one
    sign differ by at most 2 n eps relative; n is the largest group."""
    n = max(int(torch.bincount(row).max()) for row in seg)
    return 2 * n * torch.finfo(dtype).eps


# (B, C) of the merge: the main path (C = 8 * 1024), the fleet (8 x 2 *
# 1024), the tiled path up to the full expansion M * Np = 262,144, and the
# edges of the one-block path (C <= 4096) and of the old cap
MERGE_SHAPES = [(1, 8192), (8, 2048), (1, 65536), (1, 262144), (8, 65536),
                (1, 1), (1, 7), (1, 4096), (1, 4097), (1, 8193)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", MERGE_SHAPES,
                         ids=[f"{b}x{c}" for b, c in MERGE_SHAPES])
@pytest.mark.parametrize("kb", [19, None])
def test_merge_kernel_any_size_matches_plain(cuda, dtype, shape, kb):
    """K2 at every size it takes, with kb key bits (chimera-2048's 19) or
    all 32: perm, seg, Emin, first_min and the degeneracies exactly, gprob
    within the reordered sum's tolerance."""
    B, C = shape
    args = _keyed_set(np.random.default_rng(C + B), B, C, 19, dtype, cuda)
    before = kernels.merge_segments.launches
    got = kernels.merge_segments(*args, 1e-12, key_bits=kb)
    assert kernels.merge_segments.launches == before + 1
    want = kernels.merge_segments_plain(*args, 1e-12)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    rtol = _gprob_rtol(want[1], dtype)
    torch.testing.assert_close(got[4], want[4], rtol=rtol, atol=rtol)
    # the order of the sums is fixed: a second call gives the same bits
    assert torch.equal(kernels.merge_segments(*args, 1e-12, key_bits=kb)[4],
                       got[4])


@pytest.mark.gpu
def test_merge_kernel_refuses_wrong_dtypes_and_shapes(cuda):
    args = _keyed_set(np.random.default_rng(0), 2, 300, 19, torch.float32,
                      cuda)
    bad = [
        (args[0].long(),) + args[1:],                      # int64 keys
        args[:1] + (args[1].float(),) + args[2:],          # float32 energies
        args[:2] + (args[2].half(),) + args[3:],           # float16 probs
        args[:3] + (args[3].to(torch.uint8),) + args[4:],  # valid not bool
        args[:4] + (args[4].int(),),                       # int32 degeneracy
        args[:1] + (args[1][:, :-1],) + args[2:],          # a short row
        tuple(a[..., None] for a in args),                 # (B, C, 1)
        args[:2] + (args[2].cpu(),) + args[3:],            # another device
        tuple(a[:, :0] for a in args),                     # C = 0
    ]
    for case in bad:
        with pytest.raises(ValueError):
            kernels.merge_segments(*case, 1e-12)
    with pytest.raises(ValueError):
        kernels.merge_segments(*args, 1e-12, key_bits=32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_kernel_batched_matches_plain(cuda, dtype):
    """The fleet's merge: 8 instances of C = 2048 in one launch, each row
    equal to its own plain run."""
    rng = np.random.default_rng(1)
    sets = [candidate_set(rng, 1024, 2048, 8, 4) for _ in range(8)]
    key1 = np.stack([candidate_key1(v, ok) for v, _, _, ok, _ in sets])
    args = [_t(key1).to(cuda)] + [_t(np.stack(x)).to(cuda)
                                  for x in list(zip(*sets))[1:]]
    args[2] = args[2].to(dtype)
    before = kernels.merge_segments.launches
    got = kernels.merge_segments(*args, 1e-12)
    assert kernels.merge_segments.launches == before + 1
    for b in range(8):
        want = kernels.merge_segments_plain(*(a[b] for a in args), 1e-12)
        for i in (0, 1, 2, 3, 5):
            assert torch.equal(got[i][b], want[i]), (b, i)
        torch.testing.assert_close(got[4][b], want[4], rtol=_rtol(dtype),
                                   atol=_rtol(dtype))


def _batched_marginal_args(rng, cuda, dtype, nvalids, M=1024):
    """K3's inputs at full width for one instance per entry of
    ``nvalids``: lBT with the states last and int64 indices, as the search
    holds them, and the cutoff window."""
    ins = [marginal_inputs(rng, M=M, Np=256, lh=16, lv=16, D=32,
                           nvalid=nv) for nv in nvalids]
    B = len(nvalids)
    lB, drindex, AT, RL, RRsel, lidx, uidx = (
        _t(np.stack(x)).to(cuda) for x in list(zip(*ins))[:7])
    T2 = engine._marginal_T2(*(x.to(dtype) for x in (AT, RL, RRsel)))
    return (T2, kernels.marginal.boltzmann_columns(lB.to(dtype)),
            drindex.long(), lidx.long(), uidx.long(),
            torch.tensor(nvalids, device=cuda),
            _t(-np.abs(rng.standard_normal((B, M))) * 40).to(cuda, dtype),
            _t(rng.random((B, M)) < 0.7).to(cuda), float(np.log2(1e-8)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nvalids", [[200], [200, 256, 97, 1, 256, 180, 64,
                                           255]], ids=["B1", "B8"])
def test_marginal_kernel_matches_plain(cuda, dtype, nvalids):
    """K3's five outputs against the plain version's; its reductions equal
    the same reductions of its own probf and mPn exactly."""
    args = _batched_marginal_args(np.random.default_rng(2), cuda, dtype,
                                  nvalids)
    before = kernels.marginal_epilogue.launches
    got = kernels.marginal_epilogue(*args)
    assert kernels.marginal_epilogue.launches == before + 1
    want = kernels.marginal_epilogue_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=_rtol(dtype), atol=_rtol(dtype))
    probf, mPn, pmax, mq, mqc = got
    prob, valid, log2_cutoff = args[6:]
    B = len(nvalids)
    assert torch.equal(pmax, probf.reshape(B, -1).amax(dim=1))
    assert torch.equal(mq, torch.where(valid, mPn, 0.0).amin(dim=1))
    bmax = torch.where(valid, prob, kernels.marginal.NEG).amax(
        dim=1, keepdim=True)
    core = valid & (prob > bmax + log2_cutoff)
    assert torch.equal(mqc, torch.where(core, mPn, 0.0).amin(dim=1))


def _site_args(rng, cuda, dtype, nvalids, M, D):
    """K4's inputs at full width (Np=256, lh=lv=16) for one instance per
    entry of ``nvalids``, as the sampler holds them: T2 from the two GEMMs,
    the table with the states last, int64 drindex/nvalid, int32 dmap,
    rmap, vind and states; uniforms in the dtype, mq = +inf."""
    ins = [marginal_inputs(rng, M=M, Np=256, lh=16, lv=16, D=D,
                           nvalid=nv) for nv in nvalids]
    B = len(nvalids)
    lB, drindex, AT, RL, RRsel, lidx, uidx = (
        _t(np.stack(x)).to(cuda) for x in list(zip(*ins))[:7])
    AT, RL = AT.to(dtype), RL.to(dtype)
    vind = _t(rng.integers(0, 16, size=(B, M, 17)).astype(np.int32)).to(cuda)
    vind[:, :, 5], vind[:, :, 6] = lidx, uidx
    return dict(
        T2=engine._marginal_T2(AT, RL, RRsel.to(dtype)),
        lBT=kernels.marginal.boltzmann_columns(lB.to(dtype)),
        drindex=drindex.long(),
        dmap=_t(rng.integers(0, 16, size=(B, 256)).astype(np.int32)).to(cuda),
        rmap=_t(rng.integers(0, 16, size=(B, 256)).astype(np.int32)).to(cuda),
        nvalid=torch.tensor(nvalids, device=cuda),
        u=_t(rng.random((B, M))).to(cuda, dtype), AT=AT, RL=RL, vind=vind,
        states=torch.zeros((B, M, 256), dtype=torch.int32, device=cuda),
        nx=5, col=37,
        mq=torch.full((B,), float("inf"), dtype=dtype, device=cuda))


SITE_KEYS = ("T2", "lBT", "drindex", "dmap", "rmap", "nvalid", "u", "AT",
             "RL", "vind", "states", "nx", "col", "mq")


def site_check(a, dtype):
    """Run K4 and its plain version on copies of the inputs ``a``; check
    the draws by ``draw_mismatches``, vind and states exactly where the
    draws agree, RL' within rtol there, mPn within rtol, mq exactly the
    minimum of the kernel's own mPn. Returns (draws that differ, draws)."""
    ka = dict(a, vind=a["vind"].clone(), states=a["states"].clone(),
              mq=a["mq"].clone())
    pa = dict(a, vind=a["vind"].clone(), states=a["states"].clone(),
              mq=a["mq"].clone())
    before = kernels.sample_site.launches
    RL_k, mPn_k = kernels.sample_site(*(ka[k] for k in SITE_KEYS))
    assert kernels.sample_site.launches == before + 1
    RL_p, mPn_p = kernels.sample_site_plain(*(pa[k] for k in SITE_KEYS))
    nx, col = a["nx"], a["col"]
    ind_k, ind_p = ka["states"][:, :, col], pa["states"][:, :, col]
    args = (a["T2"], a["lBT"], a["drindex"],
            a["vind"][:, :, nx], a["vind"][:, :, nx + 1], a["nvalid"], a["u"])
    n_bad, unexplained = kernels.sample.draw_mismatches(ind_k, ind_p, args)
    assert unexplained == 0
    assert n_bad <= (0 if dtype == torch.float64 else 1e-3 * ind_k.numel())
    assert bool(((ind_k >= 0) & (ind_k < a["nvalid"][:, None])).all())
    same = ind_k == ind_p
    assert torch.equal(ka["states"][same], pa["states"][same])
    assert torch.equal(ka["vind"][same], pa["vind"][same])
    others = torch.ones_like(ka["states"], dtype=torch.bool)
    others[:, :, col] = False
    assert torch.equal(ka["states"][others], a["states"][others])
    keep = torch.ones_like(ka["vind"], dtype=torch.bool)
    keep[:, :, nx:nx + 2] = False
    assert torch.equal(ka["vind"][keep], a["vind"][keep])
    rtol = _rtol(dtype)
    torch.testing.assert_close(RL_k[same], RL_p[same], rtol=rtol, atol=rtol)
    torch.testing.assert_close(mPn_k, mPn_p, rtol=rtol, atol=rtol)
    assert torch.equal(ka["mq"], torch.minimum(a["mq"], mPn_k.amin(dim=1)))
    return n_bad, ind_k.numel()


# (counts of valid states per instance, walkers): the e02 single run and
# fleet, chimera-2048's walkers, and a fleet whose instances differ
DRAW_CASES = {"B1_M128": ([256], 128), "B8_M128": ([256] * 8, 128),
              "B1_M1024": ([256], 1024),
              "B8_ragged": ([200, 256, 97, 1, 256, 180, 64, 255], 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(DRAW_CASES))
@pytest.mark.parametrize("D", [32, 48])
def test_sample_site_kernel_matches_plain(cuda, dtype, case, D):
    nvalids, M = DRAW_CASES[case]
    site_check(_site_args(np.random.default_rng(3), cuda, dtype, nvalids, M,
                          D), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("Np", [16, 100, 1000])
def test_sample_site_kernel_other_widths(cuda, Np):
    """K4 at a narrow row (one state per lane), a ragged one (padding
    states) and one held in shared memory, float64, D = 8."""
    rng = np.random.default_rng(Np)
    B, M, lh, lv, D = 2, 64, 4, 8, 8
    nvalids = [Np, Np // 2 + 1]
    lB = -np.abs(rng.standard_normal((B, Np, lh, lv))) * 30
    lB[1, Np // 2 + 1:] = -np.inf
    T2 = np.abs(rng.standard_normal((B, M, lh * lv)))
    T2[:, ::7] -= 0.5
    a = dict(
        T2=_t(T2).to(cuda),
        lBT=kernels.marginal.boltzmann_columns(_t(lB).to(cuda)),
        drindex=_t(rng.integers(0, lh * lv, size=(B, Np))).to(cuda),
        dmap=_t(rng.integers(0, lv, size=(B, Np)).astype(np.int32)).to(cuda),
        rmap=_t(rng.integers(0, lh, size=(B, Np)).astype(np.int32)).to(cuda),
        nvalid=torch.tensor(nvalids, device=cuda),
        u=_t(rng.random((B, M))).to(cuda),
        AT=_t(rng.standard_normal((B, D, lv, D))).to(cuda),
        RL=_t(rng.standard_normal((B, M, D))).to(cuda),
        vind=_t(np.stack([rng.integers(0, lh, size=(B, M)),
                          rng.integers(0, lv, size=(B, M))], axis=2)
                .astype(np.int32)).to(cuda),
        states=torch.zeros((B, M, 3), dtype=torch.int32, device=cuda),
        nx=0, col=1,
        mq=torch.full((B,), float("inf"), dtype=torch.float64, device=cuda))
    site_check(a, torch.float64)


@pytest.mark.gpu
def test_sample_site_kernel_refuses_wrong_inputs(cuda):
    a = _site_args(np.random.default_rng(4), cuda, torch.float32, [256], 32,
                   32)
    bad = [dict(drindex=a["drindex"].int()), dict(dmap=a["dmap"].long()),
           dict(vind=a["vind"].long()), dict(u=a["u"].double()),
           dict(mq=a["mq"][:0]), dict(col=256), dict(nx=16),
           dict(states=a["states"].transpose(1, 2).contiguous()
                .transpose(1, 2)),
           dict(AT=a["AT"].cpu())]
    for change in bad:
        with pytest.raises(ValueError):
            kernels.sample_site(*(dict(a, **change)[k] for k in SITE_KEYS))


@pytest.mark.gpu
def test_search_loop_never_syncs(cuda):
    """The beam search over all rows reads nothing back to the host:
    with CUDA sync debugging set to error, any synchronizing call in
    full_search_scan raises."""
    import os
    import tnax_torch as tt
    from tnax_torch import parallel, search
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera128_synth_s0.txt")
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float32)
    g = engine.pad_grid(ins.problem)

    def fleet(a, dtype=None):
        # two copies of the instance: a batch of two
        t = _t(np.stack([a, a])).to(cuda)
        return t if dtype is None else t.to(dtype)

    X = {k: fleet(v, torch.float32)
         for k, v in engine.identity_gauges(g).items()}
    f32 = [fleet(a, torch.float32) for a in (g.Es, g.Esl, g.Esu)]
    dmap, rmap = fleet(g.dmap), fleet(g.rmap)
    lB, Wt = engine.peps_rows(*f32, dmap, rmap, X["Xl"], X["Xr"], X["Xu"],
                              X["Xd"], 3.0, lh=g.lh, lv=g.lv)
    M, D = 256, 16
    rhoT = engine.build_rhoT(Wt, Dmax=D, tolS=1e-16, tolV=1e-10,
                             max_sweeps=2)[0]
    raw = [fleet(a, torch.float64)
           for a in search.padded_energy_rows(ins.problem)]
    cols = (np.arange(4)[:, None] * 4 + np.arange(4)[None, :]).tolist()
    grid_in = dict(lBT=kernels.marginal.boltzmann_columns(lB),
                   drindex=dmap.long() * g.lh + rmap.long(),
                   Es=raw[0], Esl=raw[1], Esu=raw[2], dmap=dmap, rmap=rmap,
                   nvalid=fleet(g.nstates).long(), cols=cols)
    beam0 = parallel._initial_beam(2, M, D, 4, 4, torch.float32, cuda)
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


@pytest.mark.gpu
@pytest.mark.parametrize("cand_factor", [8, 64, None],
                         ids=["topk", "compact", "full"])
def test_records_dispatch_never_syncs(cuda, cand_factor):
    """The spectrum's records of every row are launched, and their copies
    to pinned host memory started, without one synchronizing call; the
    rows then arrive, each marked by its event."""
    import os
    import tnax_torch as tt
    from tnax_torch import spectrum
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera128_synth_s0.txt")
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    M = 256
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float64)
    ctx = ins._context()
    ctx.build_boundary(8, 1e-16, 1e-10, 2, rsvd=False)
    C, P = spectrum.caps(M, ctx.Np, cand_factor)
    kw = dict(M=M, C=C, P=P, relative_P_cutoff=1e-8, min_dEng=1e-12)
    spectrum.dispatch_records(ctx, **kw)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layout, rows = spectrum.dispatch_records(ctx, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(isinstance(e, torch.cuda.Event) and h.is_pinned()
               for h, e in rows)
    R = spectrum._row_records(rows[-1], layout, 0)
    assert int(R["out_valid"][-1].sum()) > 0
    assert bool((R["count"] > 0).all())


def _rmf_site_args(rng, cuda, dtype, B, M=1024, D=32):
    """K3's inputs at the widths of an RMF site of 3-state variables
    (Np = 3, legs of 3): lB with one forbidden (state, leg) pair and a
    variable with two states, int64 indices, the cutoff window."""
    Np = lh = lv = 3
    lB = -np.abs(rng.standard_normal((B, Np, lh, lv))) * 8
    lB[:, 1, 2, :] = -np.inf
    drindex = np.stack([rng.permutation(lh * lv)[:Np] for _ in range(B)])
    AT = rng.standard_normal((B, D, lv, D))
    RL = rng.standard_normal((B, M, D))
    RRsel = np.abs(rng.standard_normal((B, M, D, lh)))
    T2 = engine._marginal_T2(*(_t(x).to(cuda, dtype) for x in (AT, RL,
                                                                RRsel)))
    return (T2, kernels.marginal.boltzmann_columns(_t(lB).to(cuda, dtype)),
            _t(drindex).to(cuda).long(),
            _t(rng.integers(0, lh, size=(B, M))).to(cuda),
            _t(rng.integers(0, lv, size=(B, M))).to(cuda),
            torch.tensor([3, 2] * (B // 2) + [3] * (B % 2), device=cuda),
            _t(-np.abs(rng.standard_normal((B, M))) * 10).to(cuda, dtype),
            _t(rng.random((B, M)) < 0.8).to(cuda), float(np.log2(1e-12)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 8])
def test_kernels_at_rmf_widths_match_plain(cuda, dtype, B):
    """K3 and K2 at the RMF widths of e05 (Np = 3, lh = lv = 3, so 2 bits
    per leg value): K3's outputs, and K2 on the full expansion's 3 M
    candidates with the search's key_bits (log2 M + 2 * 2 + 1 = 15)."""
    rng = np.random.default_rng(30 + B)
    args = _rmf_site_args(rng, cuda, dtype, B)
    got = kernels.marginal_epilogue(*args)
    want = kernels.marginal_epilogue_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=_rtol(dtype), atol=_rtol(dtype))
    kb = (1024 - 1).bit_length() + 2 * 2 + 1
    keyed = _keyed_set(rng, B, 3 * 1024, kb, dtype, cuda)
    got = kernels.merge_segments(*keyed, 1e-12, key_bits=kb)
    want = kernels.merge_segments_plain(*keyed, 1e-12)
    for i in (0, 1, 2, 3, 5):
        assert torch.equal(got[i], want[i]), i
    rtol = _gprob_rtol(want[1], dtype)
    torch.testing.assert_close(got[4], want[4], rtol=rtol, atol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_host_search_reads_once_per_site(cuda, dtype):
    """The host-exact search on chimera-128 (M = 256, cutoff 1e-8, so the
    float32 fast path holds at every site) waits for the device once per
    site, its one read, and launches K3 once per site, K2 never; under
    CUDA sync debugging each wait warns once."""
    import os
    import warnings
    import tnax_torch as tt
    from tnax_torch import search
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera128_synth_s0.txt")
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                    device="cuda", dtype=dtype)
    kw = dict(M=256, relative_P_cutoff=1e-8, Dmax=8)
    ctx = ins._context()
    search.search_ground_state(ctx, **kw)   # builds the boundary, warms up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = search.search_ground_state(ctx, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 16, [str(w.message) for w in syncs[:3]]
    counts = kernels.launch_counts()
    assert counts["marginal_epilogue"] == 16 and counts["merge"] == 0
    ins.set_result(res)
    np.testing.assert_allclose(tt.energy_Jij(J, ins.binary_states()),
                               ins.energy, atol=1e-9)


@pytest.mark.gpu
def test_host_sampler_runs_k4_per_site(cuda):
    """Gibbs sampling on the host path launches K4 once per site and no
    plain marginal: the NumPy uniforms go to the device sampler."""
    import os
    import tnax_torch as tt
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera128_synth_s0.txt")
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float64)
    kernels.reset_launch_counts()
    E = ins.gibbs_sampling(M=64, Dmax=16, seed=1)
    assert kernels.launch_counts() == dict(gebal=0, merge=0,
                                           marginal_epilogue=0,
                                           sample_site=16, polish=0,
                                           zipup=0, svd=0)
    np.testing.assert_allclose(tt.energy_Jij(J, ins.binary_states()), E,
                               atol=1e-9)


def _chimera128(dtype):
    import os
    import tnax_torch as tt
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera128_synth_s0.txt")
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    return tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3,
                     device="cuda", dtype=dtype)


@pytest.mark.gpu
def test_host_ud_matches_the_device_ladder(cuda):
    """On the card in float64 at chimera-128, the host 'ud' sweep (its
    stacks built on the card, swept in NumPy) against the device ladder
    (K1) from the same gauges, at tnax's tolerances between its two
    paths (tests/test_precondition_device.py:56-57); K1 runs only on the
    device path."""
    from tnax_torch import engine as eng, precondition
    ins = _chimera128(torch.float64)
    g0 = eng.identity_gauges(eng.pad_grid(ins.problem))
    kw = dict(device="cuda", dtype=torch.float64)
    for beta in (0.75, 1.5):
        ov_h, ov_d = [], []
        kernels.reset_launch_counts()
        Xh = precondition.balance_ud(ins.problem, beta, g0,
                                     overlaps_out=ov_h, **kw)
        assert kernels.launch_counts()["gebal"] == 0
        Xd = precondition.balance_ud_device(ins.problem, beta, g0,
                                            overlaps_out=ov_d, **kw)
        assert kernels.launch_counts()["gebal"] == 2 * 4
        for k in Xh:
            np.testing.assert_allclose(Xd[k], Xh[k], rtol=1e-9, err_msg=k)
        np.testing.assert_allclose(ov_d[0], ov_h[0], rtol=1e-6, atol=1e-9)
        g0 = Xh


def _log2Z_columns(rhoL, lnL, rhoR, lnR):
    """log2 of the contraction at every column interface k = 1..Nx-1."""
    from tnax_torch import bmps
    z = bmps.mps_dot(rhoR[0, 1:-1], rhoL[0, 1:-1])
    return (torch.log2(z.abs()) + lnL[0, 1:-1] + lnR[0, 1:-1]).cpu()


@pytest.mark.gpu
def test_column_stacks_on_the_card_match_the_cpu(cuda):
    """build_rhoL and build_rhoR at chimera-128 in float64, D=8: the
    card's stacks give the CPU's log2 Z at every column interface
    (gauge-invariant) and its overlaps."""
    ins = _chimera128(torch.float64)
    Wt = ins._context().Wt
    kw = dict(Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20)
    outs = {}
    for dev in ("cuda", "cpu"):
        L = engine.build_rhoL(Wt.to(dev), **kw)
        R = engine.build_rhoR(Wt.to(dev), **kw)
        outs[dev] = (_log2Z_columns(L[0], L[1], R[0], R[1]),
                     L[2].cpu(), R[2].cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=0)


@pytest.mark.gpu
def test_complex_mps_canonizes_on_the_card(cuda):
    """init_mps('randC') and canonize_left on CUDA: the CPU's dense
    complex state, lognorm and <conj(A)|A>."""
    from tnax_torch import bmps

    def dense(m):
        v = m.A[0, :1]                     # (1, d, D)
        for n in range(1, m.A.shape[0]):
            v = torch.einsum("xa,adb->xdb", v.reshape(-1, v.shape[-1]),
                             m.A[n])
        return v.reshape(-1, v.shape[-1])[:, 0].cpu() \
            * 2.0 ** float(m.lognorm)

    got = {}
    for dev in ("cuda", "cpu"):
        raw = bmps.init_mps(5, 8, 3, torch.float64, initial="randC",
                            canonize="none", seed=4, device=dev)
        m, _ = bmps.canonize_left(raw)
        assert m.A.dtype == torch.complex128 and m.A.device.type == dev
        got[dev] = (dense(m), bmps.mps_dot(m.A.conj(), m.A).cpu())
    torch.testing.assert_close(got["cuda"][0], got["cpu"][0], rtol=1e-10,
                               atol=1e-12)
    torch.testing.assert_close(got["cuda"][1], got["cpu"][1], rtol=1e-10,
                               atol=0)


@pytest.mark.gpu
def test_nccl_mesh_of_one_card_matches_no_mesh(cuda):
    """sharded_search_gs on a (1, 1) NCCL mesh (the beam-sharded site
    body, its collectives on an axis of one rank) gives the unsharded
    search's result at chimera-128, and K2 and K3 run once a site."""
    import socket
    import torch.distributed as dist
    from tnax_torch import parallel
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1, 1)
        ctx = _chimera128(torch.float64)._context()
        kw = dict(M=256, relative_P_cutoff=1e-8, Dmax=16)
        kernels.reset_launch_counts()
        got = parallel.sharded_search_gs([ctx], mesh, **kw)[0]
        counts = kernels.launch_counts()
        want = parallel.multi_search_gs([ctx], **kw)[0]
    finally:
        dist.destroy_process_group()
    assert counts["merge"] == counts["marginal_epilogue"] == 16
    assert got["energy"] == want["energy"]
    assert got["degeneracy"] == want["degeneracy"]
    assert np.array_equal(got["states"], want["states"])


# ---------------------------------------------------------------------------
# K5: the ladder's variational polish
# ---------------------------------------------------------------------------

def _solver(path, side, dtype=torch.float32):
    import tnax_torch as tt
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    return tt.Solver(mode="Ising", Nx=side, Ny=side, Nc=8, J=J, beta=3,
                     device="cuda", dtype=dtype)


def _polish_rows(build, zipups=None):
    """The inputs of every polish that ``build()`` runs: (A0, phi_A, W,
    conj, tol, max_sweeps) per absorbed row, captured on the card; with a
    list ``zipups``, also each row's absorption inputs (A, lognorm, W,
    conj, tolS) into it."""
    from tnax_torch import bmps
    rows = []
    orig, orig_apply = bmps.variational_implicit, bmps.compress_apply

    def capture(mps, phi_A, W, *, conj, tol, max_sweeps):
        rows.append((mps.A.clone(), phi_A.clone(), W.clone(), conj, tol,
                     max_sweeps))
        return orig(mps, phi_A, W, conj=conj, tol=tol, max_sweeps=max_sweeps)

    def capture_apply(mps, W, Dmax, *, conj, tolS, **kw):
        zipups.append((mps.A.clone(), mps.lognorm.clone(), W.clone(), conj,
                       tolS))
        return orig_apply(mps, W, Dmax, conj=conj, tolS=tolS, **kw)

    bmps.variational_implicit = capture
    if zipups is not None:
        bmps.compress_apply = capture_apply
    try:
        build()
    finally:
        bmps.variational_implicit = orig
        bmps.compress_apply = orig_apply
    return rows


@pytest.fixture(scope="module")
def ladder_rows():
    """Real D=8 rows in float32: the two-rung ladder (betas 1.5, 3) of
    chimera-128 and chimera-2048 (two lanes a row, rhoT's and rhoB's,
    conj=True), the one-rung ladder of the eight chimera-512 instances
    (16 lanes), and chimera-128's bottom stack (conj=False). Every row
    has exactly-zero channels at its edge bonds, and the row absorbed
    last, whose outer legs hold one state, has them at every bond."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import os
    from tnax_torch import precondition
    data = os.path.join(os.path.dirname(__file__), "data")
    out = {"zipup": {}}
    zipups = out["zipup"]
    for label, name, side in (("c128", "chimera128_synth_s0.txt", 4),
                              ("c2048", "chimera2048_synth_s0.txt", 16)):
        p = _solver(os.path.join(data, name), side).problem
        out[label] = _polish_rows(lambda: precondition.precondition_fleet(
            [p], [1.5, 3.0], device="cuda", dtype=torch.float32),
            zipups.setdefault(label, []))
    ps = [_solver(os.path.join(data, f"chimera512_synth_s{s}.txt"), 8)
          .problem for s in range(1, 9)]
    out["c512x8"] = _polish_rows(lambda: precondition.precondition_fleet(
        ps, [3.0], device="cuda", dtype=torch.float32),
        zipups.setdefault("c512x8", []))
    ins = _solver(os.path.join(data, "chimera128_synth_s0.txt"), 4)
    Wt = ins._context().Wt
    out["c128_conj_false"] = _polish_rows(lambda: engine.build_rhoB(
        Wt, Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20),
        zipups.setdefault("c128_conj_false", []))
    return out


def _state_fidelity(A, B):
    """|<A|B>| / (|A| |B|) of two batched MPS (B, L, D, d, D), per lane,
    in float64."""
    from tnax_torch import bmps
    A, B = A.double(), B.double()
    return (bmps.mps_dot(A, B).abs()
            / torch.sqrt(bmps.mps_dot(A, A) * bmps.mps_dot(B, B)))


def _polish_both(A0, phi_A, Wc, tol, max_sweeps):
    """K5 and the plain polish on the same lanes, and the plain run's
    Schmidt-vector change of every pass (passes x lanes), read from
    bmps._alternate's left sweeps."""
    from tnax_torch import bmps
    got = kernels.polish_row(A0, phi_A, Wc, tol=tol, max_sweeps=max_sweeps)
    orig, changes = bmps._alternate, []

    def alternate(A, FLs, overlap, right_sweep, left_sweep, **kw):
        def left(*args):
            out = left_sweep(*args)
            changes.append(out[3].tolist())
            return out
        return orig(A, FLs, overlap, right_sweep, left, **kw)

    bmps._alternate = alternate
    try:
        want = kernels.polish_row_plain(A0, phi_A, Wc, tol=tol,
                                        max_sweeps=max_sweeps)
    finally:
        bmps._alternate = orig
    return got, want, changes


def _channel_weights(A):
    """For each site n and bond channel k of a left-canonical MPS A (B, L,
    D, d, D): the norm of the state's part to the right of bond n + 1 on
    channel k, sqrt(RR[n + 1][k, k]) (bmps._norm_envs), so that an
    error e in A[:, n, :, :, k] moves the state by about e times it.
    Returns (B, L, D)."""
    from tnax_torch import bmps
    RR = bmps._norm_envs(A.double())
    return torch.stack([torch.sqrt(torch.clamp(torch.diagonal(
        RR[n + 1], dim1=1, dim2=2), min=0.0)) for n in range(A.shape[1])],
        dim=1)


def _check_polish(row, max_sweeps=None):
    """K5 against the plain polish on one captured row, lane by lane;
    returns (sweeps of K5, of the plain polish, a list of faults).

    The rule: the stop pass is float32's. Where a lane's sweeps differ,
    the pass at which the two first decided differently, the smaller
    count s, has to lie where float32's rounding sets the change: the
    plain run's change after pass s is below 8 tol (tol = 32 eps), or no
    longer shrinks by half from the pass before (its plateau, at 2.7e-5
    to 4.3e-5 on some fleet lanes, where the 0.9 test then decides on
    rounding noise; the plain polish of a lane alone and in its batch
    round differently too, and stop apart there). Where the change still
    shrinks geometrically, by half a pass or more, and is above 8 tol,
    both sides must go on. Past that pass a lane may run on more than one
    pass. Such a lane is compared again with both sides run to s passes.
    Then, float32 tolerances: the states (the MPS as vectors) agree to a
    fidelity of 1 - 1e-6, ln_state to 1e-4 absolute (|values| ~ 10-140),
    the overlap to 1e-4 relative, and A entry by entry to 1e-3 weighted
    by the state's weight on the entry's bond channel
    (:func:`_channel_weights`): the column of a channel the state hardly
    uses is float32 noise on both sides."""
    from tnax_torch import bmps
    A0, phi_A, W, conj, tol, ms = row
    ms = ms if max_sweeps is None else max_sweeps
    Wc = bmps._orient_mpo(W, conj)
    before = kernels.polish_row.launches
    got, want, changes = _polish_both(A0, phi_A, Wc, tol, ms)
    assert kernels.polish_row.launches == before + 1
    sk, sp = got[3].clone(), want[3].clone()
    assert sk.dtype == torch.int64 and sk.device == A0.device
    faults, capped = [], {}
    lanes = [list(got), list(want)]
    for z in torch.nonzero(sk != sp).flatten().tolist():
        cap = int(min(sk[z], sp[z]))
        d = [c[z] for c in changes[:int(sp[z])]]
        if not (d[cap - 1] <= 8 * tol
                or (cap >= 2 and d[cap - 1] >= 0.5 * d[cap - 2])):
            faults.append(f"lane {z}: sweeps {int(sk[z])} vs {int(sp[z])}, "
                          f"plain changes {d}")
        if cap not in capped:
            capped[cap] = _polish_both(A0, phi_A, Wc, tol, cap)[:2]
        gz, wz = capped[cap]
        assert int(gz[3][z]) == int(wz[3][z]) == cap
        for side, new in zip(lanes, (gz, wz)):
            for t, v in zip(side, new):
                t[z] = v[z]
    got, want = lanes
    fid = _state_fidelity(got[0], want[0])
    dA = (got[0] - want[0]).abs().amax(dim=(2, 3)).double()   # (B, L, k)
    wdA = (dA * _channel_weights(want[0])).amax(dim=(1, 2))
    dln = (got[2] - want[2]).abs()
    dov = ((got[1] - want[1]).abs() / want[1].abs()).nan_to_num(0.0)
    for z in range(A0.shape[0]):
        if not (fid[z] > 1 - 1e-6 and wdA[z] <= 1e-3 and dln[z] <= 1e-4
                and dov[z] <= 1e-4):
            faults.append(f"lane {z}: 1 - fidelity {1 - float(fid[z]):.3g}, "
                          f"weighted |dA| {float(wdA[z]):.3g} (|dA| "
                          f"{float(dA[z].max()):.3g}), |d ln_state| "
                          f"{float(dln[z]):.3g}, overlap rel "
                          f"{float(dov[z]):.3g}")
    if not bool(torch.isfinite(got[0]).all()):
        faults.append("A not finite")
    return sk, sp, faults


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["c128", "c2048", "c512x8",
                                   "c128_conj_false"])
def test_polish_kernel_matches_plain_on_ladder_rows(ladder_rows, label):
    """K5 on every captured row of the instance's ladder (two lanes a
    row; 16 in the fleet), against the plain polish: see
    :func:`_check_polish` for the rule and the tolerances."""
    rows = ladder_rows[label]
    assert rows and all(r[0].shape[2:] == (8, 16, 8) for r in rows)
    assert any(bool((r[0][:, :, :, :, -1] == 0).all()) for r in rows), \
        "no row with exactly-zero channels"
    width = {"c512x8": 16, "c128_conj_false": 1}.get(label, 2)
    sweeps, faults, passes = [], [], [0, 0]
    for i, row in enumerate(rows):
        assert row[0].shape[0] == width
        sk, sp, f = _check_polish(row)
        sweeps.append(sk)
        faults += [f"row {i}: {x}" for x in f]
        passes[0] += int(sk.max())
        passes[1] += int(sp.max())
    assert not faults, "\n".join(faults)
    # the most sweeps a row, as the stage clock counts them: the same
    # passes per row within 0.5
    assert abs(passes[0] - passes[1]) <= 0.5 * len(rows), passes
    if label == "c512x8":
        # the fleet's lanes stop at different passes
        assert any(len(set(s.tolist())) > 1 for s in sweeps)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["c128", "c2048"])
def test_polish_kernel_one_lane(ladder_rows, label):
    """A lane alone (B = 1) gives what it gives among others."""
    for row in ladder_rows[label][::3]:
        A0, phi_A, W, conj, tol, ms = row
        one = (A0[1:], phi_A[1:], W[1:], conj, tol, ms)
        faults = _check_polish(one)[2]
        assert not faults, faults
        from tnax_torch import bmps
        Wc = bmps._orient_mpo(W, conj)
        alone = kernels.polish_row(A0[1:], phi_A[1:], Wc[1:], tol=tol,
                                   max_sweeps=ms)
        both = kernels.polish_row(A0, phi_A, Wc, tol=tol, max_sweeps=ms)
        for a, b in zip(alone, both):
            assert torch.equal(a, b[1:])


@pytest.mark.gpu
def test_polish_kernel_runs_lanes_to_max_sweeps(ladder_rows):
    """At a max_sweeps below the fleet's passes some lanes run to it and
    others stop before: each lane ends where its own plain run ends."""
    hits, stops, faults = 0, 0, []
    for row in ladder_rows["c512x8"]:
        for cap in (3, 5):
            sk, sp, f = _check_polish(row, max_sweeps=cap)
            faults += f
            hits += int((sk == cap).sum())
            stops += int((sk < cap).sum())
    assert not faults, faults
    assert hits > 0 and stops > 0


@pytest.mark.gpu
def test_polish_kernel_refuses_wrong_inputs(ladder_rows):
    """The wrapper raises on a dtype, shape or device K5 does not take,
    and never falls back."""
    from tnax_torch import bmps
    A0, phi_A, W, conj, tol, ms = ladder_rows["c128"][1]
    Wc = bmps._orient_mpo(W, conj)
    bad = [(A0.double(), phi_A.double(), Wc.double()),       # float64
           (A0, phi_A, Wc.cpu()),                             # two devices
           (A0[:, :, :4], phi_A, Wc),                         # bond 4
           (A0, phi_A[:, :, :4, :, :4], Wc),                  # old bond 4
           (A0[:, :, :, :8], phi_A, Wc[..., :8]),             # leg 8
           (A0[:1], phi_A, Wc),                               # lanes
           (A0.repeat(1, 5, 1, 1, 1)[:, :17],
            phi_A.repeat(1, 5, 1, 1, 1)[:, :17],
            Wc.repeat(1, 5, 1, 1, 1, 1)[:, :17])]             # 17 sites
    before = kernels.polish_row.launches
    for args in bad:
        assert not kernels.polish.engages(*args)
        with pytest.raises(ValueError):
            kernels.polish_row(*args, tol=tol, max_sweeps=ms)
    assert kernels.polish_row.launches == before
    assert kernels.polish.engages(A0, phi_A, Wc)


@pytest.mark.gpu
def test_polish_kernel_never_syncs(ladder_rows):
    """An unrecorded K5 polish through bmps.variational_implicit reads
    nothing back: with CUDA sync debugging set to error, any
    synchronizing call raises."""
    from tnax_torch import bmps
    A0, phi_A, W, conj, tol, ms = ladder_rows["c2048"][5]
    mps = bmps.MPS(A=A0, lognorm=torch.zeros(A0.shape[0], device=A0.device))
    bmps.variational_implicit(mps, phi_A, W, conj=conj, tol=tol,
                              max_sweeps=ms)    # builds, warms up
    torch.cuda.synchronize()
    before = kernels.polish_row.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, overlap, sweeps = bmps.variational_implicit(
            mps, phi_A, W, conj=conj, tol=tol, max_sweeps=ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.polish_row.launches == before + 1
    assert int(sweeps.min()) >= 1


@pytest.mark.gpu
def test_ladder_rows_run_k5_and_the_boundary_does_not(cuda):
    """A traced chimera-128 precondition on the card in float32: every
    ladder row of both rungs polishes in K5 (``#polish_k5`` = rows, K5's
    launches likewise) and ``#passes`` is the most sweeps of its rows;
    the D=48 boundary of the search never launches K5."""
    import os
    from tnax_torch import search
    ins = _solver(os.path.join(os.path.dirname(__file__), "data",
                               "chimera128_synth_s0.txt"), 4)
    kernels.reset_launch_counts()
    st = {}
    ins.precondition(path="device", stage_times=st)
    rows = sum(v for k, v in st.items() if k.endswith("#rows"))
    k5 = sum(v for k, v in st.items() if k.endswith("#polish_k5"))
    passes = sum(v for k, v in st.items() if k.endswith("#passes"))
    assert rows == 2 * 4 and k5 == rows
    assert kernels.launch_counts()["polish"] == rows
    assert rows <= passes <= 20 * rows
    kernels.reset_launch_counts()
    search.search_ground_state(ins._context(), M=64,
                               relative_P_cutoff=1e-8, Dmax=48)
    assert kernels.launch_counts()["polish"] == 0


# ---------------------------------------------------------------------------
# K6: the ladder's zip-up and truncation sweep
# ---------------------------------------------------------------------------

def _zipup_args(row):
    """K6's arguments (A, lognorm, Wc, omega) and tolS of a captured
    absorption, as bmps.compress_apply hands them over."""
    from tnax_torch import bmps
    A, ln, W, conj, tolS = row
    Wc = bmps._orient_mpo(W, conj)
    omega = bmps._zipup_sketch(A, Wc, 16, True, None)
    return (A, ln, Wc, omega), max(tolS, torch.finfo(A.dtype).eps)


def _check_zipup(row):
    """K6 against the plain three steps (``kernels.zipup_row_plain``, on
    the card) on one captured row, lane by lane; returns a list of
    faults. Float32 tolerances:

    - the right-canonized input phi entry by entry to 1e-5 and its
      lognorm to 1e-4 absolute (|values| up to ~300): the same
      Householder QR with qr_fixed's signs, which makes it unique, in
      another order of operations than cuSOLVER's;
    - the truncated zip-up A0 as a state (the MPS as a vector) to a
      fidelity of 1 - 1e-5: its site tensors are fixed only up to the
      gauge of each bond, and K6's one-sided Jacobi and the plain steps'
      SVDs (K7's on R^T of the core, a different order of rotations)
      rotate differently inside near-degenerate singular values, so the
      entries may differ where the state does not;
    - ``disc`` to 1e-4 relative or 1e-6 absolute, or its square to 128
      eps absolute, against the plain steps in float64 on the same
      inputs: the zip-up's part is sqrt(frob2 - kept2) / S0, the
      difference of two float32 sums of squares (Gm's 32,768 entries and
      the kept singular values), each of order frob2 / S0^2 (up to about
      ten here) and each rounded to some eps of itself, so disc^2 carries
      tens of eps (K6 read up to 38 against float64); where little is
      discarded, disc is that noise (1e-4 to 1e-3). The plain float32
      steps on the card carried more of it with cuSOLVER's SVDs (up to
      425 eps in disc^2 on the fleet's rows: its batched Jacobi resolves
      the core's singular values less finely), so they are no reference
      for it.
    """
    args, tolS = _zipup_args(row)
    before = kernels.zipup_row.launches
    got = kernels.zipup_row(*args, tolS=tolS)
    assert kernels.zipup_row.launches == before + 1
    want = kernels.zipup_row_plain(*args, tolS=tolS)
    want64 = kernels.zipup_row_plain(*(t.double() for t in args), tolS=tolS)
    eps = torch.finfo(torch.float32).eps
    fid = _state_fidelity(got[2], want[2])
    dphi = (got[0] - want[0]).abs().amax(dim=(1, 2, 3, 4))
    dln = (got[1] - want[1]).abs()
    dd, wd = got[3].double(), want64[3]
    disc_ok = (((dd - wd).abs() <= 1e-4 * wd.abs())
               | ((dd - wd).abs() <= 1e-6)
               | ((dd * dd - wd * wd).abs() <= 128 * eps))
    faults = []
    for z in range(args[0].shape[0]):
        if not (dphi[z] <= 1e-5 and dln[z] <= 1e-4 and fid[z] > 1 - 1e-5
                and disc_ok[z]):
            faults.append(f"lane {z}: |d phi| {float(dphi[z]):.3g}, |d ln| "
                          f"{float(dln[z]):.3g}, 1 - fidelity "
                          f"{1 - float(fid[z]):.3g}, disc {float(dd[z]):.6g}"
                          f" vs {float(wd[z]):.6g}")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        faults.append("not finite")
    return faults


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["c128", "c2048", "c512x8",
                                   "c128_conj_false"])
def test_zipup_kernel_matches_plain_on_ladder_rows(ladder_rows, label):
    """K6 on every captured row absorption of the instance's ladder (two
    lanes a row; 16 in the fleet), against the plain three steps on the
    card, one launch a row: see :func:`_check_zipup` for the
    tolerances."""
    rows = ladder_rows["zipup"][label]
    assert len(rows) == len(ladder_rows[label])
    assert all(r[0].shape[2:] == (8, 16, 8) for r in rows)
    faults = []
    for i, row in enumerate(rows):
        A, _, Wc, omega = _zipup_args(row)[0]
        assert kernels.zipup.engages(A, Wc, omega)
        faults += [f"row {i}: {x}" for x in _check_zipup(row)]
    assert not faults, "\n".join(faults)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["c128", "c2048"])
def test_zipup_kernel_one_lane(ladder_rows, label):
    """A lane alone (B = 1) gives what it gives among others, bit for
    bit, and agrees with the plain steps."""
    for row in ladder_rows["zipup"][label][::3]:
        (A, ln, Wc, omega), tolS = _zipup_args(row)
        one = (A[1:], ln[1:], row[2][1:], row[3], row[4])
        assert not _check_zipup(one)
        alone = kernels.zipup_row(A[1:], ln[1:], Wc[1:], omega, tolS=tolS)
        both = kernels.zipup_row(A, ln, Wc, omega, tolS=tolS)
        for a, b in zip(alone, both):
            assert torch.equal(a, b[1:])


@pytest.mark.gpu
def test_zipup_kernel_refuses_wrong_inputs(ladder_rows):
    """The wrapper raises on a dtype, shape or device K6 does not take,
    and never falls back."""
    (A, ln, Wc, omega), tolS = _zipup_args(ladder_rows["zipup"]["c128"][1])
    L = A.shape[1]
    bad = [(A.double(), ln.double(), Wc.double(), omega.double()),  # f64
           (A, ln, Wc.cpu(), omega),                           # two devices
           (A[:, :, :4, :, :4], ln, Wc, omega),                # bond 4
           (A[:, :, :, :8], ln, Wc[..., :8, :, :], omega),     # leg 8
           (A[:1], ln[:1], Wc, omega),                         # lanes
           (A, ln, Wc, omega[..., :32]),                       # sketch rank
           (A, ln, Wc, omega[:L - 1]),                         # sketch sites
           (A.repeat(1, 5, 1, 1, 1)[:, :17], ln,
            Wc.repeat(1, 5, 1, 1, 1, 1)[:, :17],
            omega.repeat(5, 1, 1)[:17])]                       # 17 sites
    before = kernels.zipup_row.launches
    for args in bad:
        assert not kernels.zipup.engages(args[0], args[2], args[3])
        with pytest.raises(ValueError):
            kernels.zipup_row(*args, tolS=tolS)
    with pytest.raises(ValueError):                            # lognorm
        kernels.zipup_row(A, ln[:1], Wc, omega, tolS=tolS)
    assert kernels.zipup_row.launches == before
    assert kernels.zipup.engages(A, Wc, omega)


@pytest.mark.gpu
def test_ladder_build_never_syncs(cuda):
    """An unrecorded ladder build at chimera-2048's shapes (both D=8
    stacks, 2 lanes, 16 rows of 16 sites) through engine.build_rho_both
    reads nothing back: with CUDA sync debugging set to error, any
    synchronizing call raises. Each row is one K6 and one K5 launch."""
    import os
    ins = _solver(os.path.join(os.path.dirname(__file__), "data",
                               "chimera2048_synth_s0.txt"), 16)
    Wt = ins._context().Wt
    kw = dict(Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20)
    engine.build_rho_both(Wt, **kw)     # builds, warms up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rhoT, rhoB = engine.build_rho_both(Wt, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = kernels.launch_counts()
    assert counts["zipup"] == counts["polish"] == 16
    assert bool(torch.isfinite(rhoT).all()) and bool(torch.isfinite(rhoB).all())


@pytest.mark.gpu
def test_ladder_rows_run_k6_and_the_boundary_does_not(cuda):
    """A traced chimera-128 precondition on the card in float32: every
    ladder row of both rungs runs K6 (``#zipup_k6`` = rows = K6's
    launches, beside K5's); the D=48 boundary of the search never
    launches K6."""
    import os
    from tnax_torch import search
    ins = _solver(os.path.join(os.path.dirname(__file__), "data",
                               "chimera128_synth_s0.txt"), 4)
    kernels.reset_launch_counts()
    st = {}
    ins.precondition(path="device", stage_times=st)
    rows = sum(v for k, v in st.items() if k.endswith("#rows"))
    k6 = sum(v for k, v in st.items() if k.endswith("#zipup_k6"))
    assert rows == 2 * 4 and k6 == rows
    assert st["ladder/build#zipup_k6"] == st["ladder/build#rows"]
    assert kernels.launch_counts()["zipup"] == \
        kernels.launch_counts()["polish"] == rows
    kernels.reset_launch_counts()
    st = {}
    search.search_ground_state(ins._context(), M=64,
                               relative_P_cutoff=1e-8, Dmax=48,
                               stage_times=st)
    assert kernels.launch_counts()["zipup"] == 0
    assert not any(k.endswith("#zipup_k6") for k in st)


# ---------------------------------------------------------------------------
# K7: the boundary's SVDs
# ---------------------------------------------------------------------------

EPS32 = float(torch.finfo(torch.float32).eps)
# the boundary's shapes at Dmax 48 (the zip-up's core, the truncation, the
# polish) and at Dmax 32
K7_SHAPES = [(128, 768), (96, 96), (48, 48), (96, 512), (64, 64), (32, 32)]


def _k7_case(rng, B, m, n, case):
    """B float32 matrices m x n: gaussian; rank-deficient (rank 7, with a
    spectrum over six decades); or zero-padded, a random 5 x 11 corner
    (the trivial bonds of the boundary's edge sites)."""
    if case == "random":
        M = rng.standard_normal((B, m, n))
    elif case == "rank7":
        M = (rng.standard_normal((B, m, 7)) * np.logspace(0, -6, 7)
             @ rng.standard_normal((B, 7, n)))
    else:
        M = np.zeros((B, m, n))
        M[:, :5, :11] = rng.standard_normal((B, 5, 11))
    return torch.as_tensor(M, dtype=torch.float32, device="cuda")


def _k7_faults(M, got, vals=None):
    """K7's (U, S, Vh) of M (B, m, n) against torch.linalg.svd (cuSOLVER,
    then svd_fixed's rule) and a float64 SVD, matrix by matrix; returns a
    list of faults. Float32 tolerances, tol = 32 sqrt(p) eps:

    - S to tol S[0] of the float64 values, as cuSOLVER's S;
    - U S Vh to tol ||M||_F in the Frobenius norm;
    - U's columns and Vh's rows where S > 0 orthonormal to tol; where
      max(m, n) > 256 (K7's streamed path, whose V = X^T U / S is exact
      to rounding only where S is not small beside S[0]) the side that is
      V, U where m > n, to tol S[0]^2 / (S_i S_j) in entry ij; every
      column where S = 0 zero on one side;
    - svd_fixed's rule holds (no pair mostly negative on both sides), and
      where S_j stands apart from its neighbours by more than 1e-3 S[0],
      the pair (u_j, v_j) is the library's: u_j v_j^T alike, and the
      same signs wherever the rule fixes them;
    - the svdvals entry's S (``vals``) equal to the svd entry's, bit for
      bit: the same rotations, without the accumulation."""
    from tnax_torch import bmps
    U, S, Vh = got
    B, m, n = M.shape
    p = min(m, n)
    tol = 32 * p ** 0.5 * EPS32
    Ul, Sl, Vhl = bmps.svd_fixed_plain(M)
    S64 = torch.linalg.svdvals(M.double())
    faults = []
    if vals is not None and not torch.equal(vals, S):
        faults.append("svdvals differs from svd's S")
    for z in range(B):
        s0 = float(S64[z, 0])
        if s0 == 0.0:
            if S[z].abs().max() > 0 or not torch.isfinite(U[z]).all():
                faults.append(f"{z}: zero matrix, S {S[z, :3].tolist()}")
            continue
        ds = float((S[z].double() - S64[z]).abs().max()) / s0
        dl = float((Sl[z].double() - S64[z]).abs().max()) / s0
        rec = float(torch.linalg.norm(
            (U[z].double() * S[z].double()) @ Vh[z].double()
            - M[z].double()) / torch.linalg.norm(M[z].double()))
        live = S[z] > 0
        u, vh, s = U[z][:, live].double(), Vh[z][live].double(), \
            S[z][live].double()
        eye = torch.eye(len(s), dtype=u.dtype, device=u.device)
        gu, gv = (u.T @ u - eye).abs(), (vh @ vh.T - eye).abs()
        if max(m, n) > 256:
            wt = s[:, None] * s[None, :] / s0 ** 2
            gu, gv = (gu * wt, gv) if m > n else (gu, gv * wt)
        ou = float(gu.max()) if gu.numel() else 0.0
        ov = float(gv.max()) if gv.numel() else 0.0
        dead = ~live
        zero_side = bool(((U[z][:, dead] == 0).all(0)
                          | (Vh[z][dead] == 0).all(1)).all())
        bad = ((U[z].amin(0).abs() > U[z].amax(0))
               & (Vh[z].amin(1).abs() > Vh[z].amax(1)))
        ok = ds <= tol and rec <= tol and ou <= tol and ov <= tol \
            and zero_side and not bool(bad.any())
        # the library's pairs where S stands apart
        Sd = S64[z].to(S.dtype)
        gap = torch.minimum(
            torch.cat([Sd[:1] * 0 + np.inf, Sd[:-1] - Sd[1:]]),
            torch.cat([Sd[:-1] - Sd[1:], Sd[-1:]]))
        for j in torch.nonzero(gap > 1e-3 * s0).flatten().tolist():
            cu = float(U[z][:, j] @ Ul[z][:, j])
            cv = float(Vh[z][j] @ Vhl[z][j])
            fixed = bool((Ul[z][:, j].amin().abs() > Ul[z][:, j].amax())
                         == (Vhl[z][j].amin().abs() > Vhl[z][j].amax()))
            if abs(abs(cu) - 1) > 1e-3 or abs(abs(cv) - 1) > 1e-3 \
                    or cu * cv < 0 or (fixed and cu < 0):
                ok = False
                faults.append(f"{z}: pair {j} u.u_lib {cu:.6f}, v.v_lib "
                              f"{cv:.6f}, rule fixes the sign: {fixed}")
                break
        if not ok:
            faults.append(f"{z}: |dS|/S0 {ds:.3g} (library {dl:.3g}), "
                          f"|USVh - M|/|M| {rec:.3g}, U {ou:.3g}, Vh "
                          f"{ov:.3g}, zero side {zero_side}, left to flip "
                          f"{int(bad.sum())} (tol {tol:.3g})")
    return faults


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "rank7", "padded"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("shape", K7_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_svd_kernel_matches_the_library(cuda, shape, B, case):
    """K7 at the boundary's shapes, and transposed, against
    torch.linalg.svd (see :func:`_k7_faults` for the tolerances); one
    launch a call, svd's and svdvals' alike; a matrix alone gives what it
    gives in a batch, bit for bit."""
    rng = np.random.default_rng(sum(shape) + B)
    faults = []
    for m, n in (shape, shape[::-1]):
        M = _k7_case(rng, B, m, n, case)
        assert kernels.svd.engages(M)
        before = kernels.launch_counts()["svd"]
        got = kernels.svd_fixed(M)
        vals = kernels.svdvals(M)
        assert kernels.launch_counts()["svd"] == before + 2
        faults += [f"{m}x{n}: {f}" for f in _k7_faults(M, got, vals)]
        alone = kernels.svd_fixed(M[-1:])
        for a, b in zip(alone, got):
            assert torch.equal(a[0], b[-1])
    assert not faults, "\n".join(faults)


@pytest.fixture(scope="module")
def boundary_svds():
    """Every matrix the chimera-128 boundary build at Dmax 48 hands to
    K7 on the card in float32, each with the entry it took (svd or
    svdvals): the zip-up's sketched cores, the truncation sweep's
    matrices and the polish's triangular factors; their edge sites have
    the trivial bonds zero-padded to 48."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import os
    from tnax_torch import bmps
    ins = _solver(os.path.join(os.path.dirname(__file__), "data",
                               "chimera128_synth_s0.txt"), 4)
    ins.precondition()
    caught, orig = [], bmps._svd_k7

    def take(M, vectors):
        caught.append(("svd" if vectors else "vals", M.clone()))
        return orig(M, vectors)

    bmps._svd_k7 = take
    try:
        ins._context().build_boundary(48, 1e-16, 1e-10, 20)
    finally:
        bmps._svd_k7 = orig
    return caught


@pytest.mark.gpu
def test_svd_kernel_on_the_boundary_matrices(boundary_svds):
    """K7 on every captured matrix of a chimera-128 Dmax=48 boundary
    build, one at a time and the polish's stacked eight at a time,
    against torch.linalg.svd (:func:`_k7_faults`)."""
    shapes = {tuple(M.shape[-2:]) for _, M in boundary_svds}
    assert {(128, 768), (96, 96), (48, 48)} <= shapes
    faults = []
    for i, (kind, M) in enumerate(boundary_svds):
        got = kernels.svd_fixed(M)
        faults += [f"{kind} {i} {tuple(M.shape)}: {f}"
                   for f in _k7_faults(M, got, kernels.svdvals(M))]
    polish = torch.cat([M for kind, M in boundary_svds if kind == "vals"])
    for k in range(0, len(polish) - 7, 8):
        M = polish[k:k + 8]
        faults += [f"polish batch {k}: {f}"
                   for f in _k7_faults(M, kernels.svd_fixed(M),
                                       kernels.svdvals(M))]
    assert not faults, "\n".join(faults[:20])


@pytest.mark.gpu
def test_svd_kernel_resolves_a_core_s_small_kept_values(cuda):
    """A zip-up core that chimera-2048's float32 ladder hands its SVD
    (48 x 128, tests/data/chimera2048_synth_s0_ladder_core.npy): the 14th
    to 16th of the 16 singular values the zip-up keeps lie at 8.3, 7.7
    and 6.8 eps S[0], the 17th at 2.5, so the cut's gap is 4.2 eps S[0].
    No pair is tied, and float32 resolves them (LAPACK's float32 SVD to
    1.4 eps S[0]). K7 holds the first 17 to half the gap, so it orders
    them at the cut as float64 does, and its top-16 left subspace misses
    at most 1e-13 of the weight float64's keeps: a floor that zeroed them
    missed 2e-12, and the plain zip-up steps of the row with it landed
    1 - fidelity 5e-5 from float64."""
    import os
    path = os.path.join(os.path.dirname(__file__), "data",
                        "chimera2048_synth_s0_ladder_core.npy")
    M = torch.as_tensor(np.load(path), device=cuda)[None]
    U, S, Vh = kernels.svd_fixed(M)
    U64, S64, _ = torch.linalg.svd(M[0].double(), full_matrices=False)
    s0, k = float(S64[0]), 16
    gap = float(S64[k - 1] - S64[k])
    assert 4 * EPS32 * s0 < gap < 5 * EPS32 * s0
    ds = float((S[0, :k + 1].double() - S64[:k + 1]).abs().max())
    P = U[0, :, :k].double()
    A = U64[:, :k] * S64[:k]
    miss = float(torch.linalg.norm(A - P @ (P.T @ A)) ** 2
                 / (S64 ** 2).sum())
    assert ds <= gap / 2, f"|dS| {ds / (EPS32 * s0):.3g} eps S[0]"
    assert miss <= 1e-13, f"missed {miss:.3g} of the weight"
    assert not _k7_faults(M, (U, S, Vh), kernels.svdvals(M))


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["c128", "c2048", "c512x8"])
def test_zipup_plain_steps_with_k7_match_float64(ladder_rows, label):
    """The plain zip-up steps (``kernels.zipup_row_plain``) on the card in
    float32, their SVDs in K7 (the 48 x 128 cores, the 16 x 16
    truncations), on every captured ladder row: the truncated state
    against the same steps in float64, lane by lane, to a fidelity of
    1 - 1e-6. Where a row's cut falls near float32's resolution, any
    float32 SVD moves the state: on these rows K7 read up to 3.1e-8,
    the library's SVDs 1.3e-7 and K6 1.1e-7 against float64, and K7
    with a negligible floor of 8 eps ||R||_F 5.1e-5 (chimera-2048's row
    25, H100); K6 against the plain steps is held to 1 - 1e-5."""
    faults = []
    for i, row in enumerate(ladder_rows["zipup"][label]):
        args, tolS = _zipup_args(row)
        before = kernels.launch_counts()["svd"]
        got = kernels.zipup_row_plain(*args, tolS=tolS)
        assert kernels.launch_counts()["svd"] > before
        want = kernels.zipup_row_plain(*(t.double() for t in args),
                                       tolS=tolS)
        off = 1 - _state_fidelity(got[2], want[2])
        faults += [f"row {i} lane {z}: 1 - fidelity {float(v):.3g}"
                   for z, v in enumerate(off) if not v <= 1e-6]
    assert not faults, "\n".join(faults)


@pytest.mark.gpu
def test_svd_kernel_refuses_wrong_inputs(cuda):
    """The wrappers raise on a dtype, shape or device K7 does not take,
    never fall back, and count no launch; a matrix with a NaN gives NaN."""
    good = torch.ones((2, 48, 48), device=cuda)
    bad = [good.double(), good.half(), torch.ones((2, 129, 129),
                                                  device=cuda),
           torch.ones((1, 1, 4097), device=cuda),
           torch.ones((0, 48, 48), device=cuda), torch.ones(48, device=cuda)]
    before = kernels.launch_counts()["svd"]
    for M in bad:
        assert not kernels.svd.engages(M)
        for fn in (kernels.svd_fixed, kernels.svdvals):
            with pytest.raises(ValueError):
                fn(M)
    assert kernels.launch_counts()["svd"] == before
    good[1, 3, 4] = float("nan")
    U, S, Vh = kernels.svd_fixed(good)
    assert torch.isfinite(S[0]).all() and torch.isnan(S[1]).all()


def _k7_boundary_ctx():
    import os
    ins = _solver(os.path.join(os.path.dirname(__file__), "data",
                               "chimera128_synth_s0.txt"), 4)
    ins.precondition()
    return ins._context()


@pytest.mark.gpu
def test_boundary_syncs_only_at_the_polish_stop(cuda):
    """A recorded chimera-128 boundary build at Dmax 48 on the card waits
    for the device only where the polish reads its stop (``_alternate``:
    one read before a row's first pass and one after each): under CUDA
    sync debugging each wait warns once, rows + passes in all. Every SVD
    of it runs K7: ``#svd_k7`` is the build's SVD calls (2 L a row, the
    zip-up's and the truncation's, and 2 L - 1 a pass) and K7's launches;
    K5 and K6 do not launch."""
    import warnings
    from tnax_torch import config
    ctx = _k7_boundary_ctx()
    ctx.build_boundary(48, 1e-16, 1e-10, 20)      # builds K7, warms up
    ctx._boundary_key = None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with config.StageClock({}, cuda) as clock:
                ctx.build_boundary(48, 1e-16, 1e-10, 20)
                counters = dict(clock.counters)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    rows, passes, L = counters["rows"], counters["passes"], 4
    assert rows == 4 and passes >= rows
    assert len(syncs) == rows + passes, [str(w.message) for w in syncs[:3]]
    counts = kernels.launch_counts()
    assert counters["svd_k7"] == counts["svd"] \
        == rows * 2 * L + passes * (2 * L - 1)
    assert counts["polish"] == counts["zipup"] == 0


@pytest.mark.gpu
def test_boundary_results_match_the_plain_path(cuda, monkeypatch):
    """The ground-state energy and degeneracy of chimera-128, and of one
    chimera-512 batch of 8, with K7 and with the plain path on the card
    (``kernels.svd.engages`` patched to False); the boundary overlaps of
    the chimera-128 build agree to 1e-4 of their size, which float32
    rounding of the two SVDs moves."""
    import os
    from tnax_torch import parallel
    from tnax_torch.kernels import svd as k7
    data = os.path.join(os.path.dirname(__file__), "data")

    def run():
        ctx = _k7_boundary_ctx()
        ctx.build_boundary(48, 1e-16, 1e-10, 20)
        ins = _solver(os.path.join(data, "chimera128_synth_s0.txt"), 4)
        E = ins.search_ground_state(M=1024, relative_P_cutoff=1e-8, Dmax=48,
                                    path="device")
        fleet = [_solver(os.path.join(data, f"chimera512_synth_s{s}.txt"), 8)
                 for s in range(1, 9)]
        res = parallel.multi_flagship_search_gs(
            fleet, M=1024, relative_P_cutoff=1e-8, Dmax=48, cand_factor=8)
        return (ctx.rhoT_overlap.double().cpu(), E[0], ins.degeneracy,
                [(r["energy"], r["degeneracy"]) for r in res])

    kernels.reset_launch_counts()
    got = run()
    assert kernels.launch_counts()["svd"] > 0
    monkeypatch.setattr(k7, "engages", lambda M: False)
    kernels.reset_launch_counts()
    want = run()
    assert kernels.launch_counts()["svd"] == 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    assert abs(got[1] - want[1]) <= 1e-3 and got[2] == want[2]
    for (e1, d1), (e2, d2) in zip(got[3], want[3]):
        assert abs(e1 - e2) <= 1e-3 and d1 == d2
