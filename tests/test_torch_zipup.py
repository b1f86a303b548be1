"""The zip-up's dispatch to K6 (``kernels.zipup``) on the CPU: the
envelope of rows K6 takes; CPU tensors take the plain three steps, bit
for bit what ``bmps.compress_apply`` ran before K6, and launch nothing;
the stage clock's counter of a K6 row (``#zipup_k6``) with the branch
forced on the CPU, and that the branch waits for nothing. The kernel
itself runs only on the card (tests/test_torch_gpu.py)."""

import pytest
import torch

import tnax_torch as tt
from tnax_torch import bmps, config, engine, kernels
from tnax_torch.kernels import zipup
from torch_helpers import droplet_J


def _solver(J, n, dtype=torch.float64):
    return tt.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, beta=3, J=J,
                     device="cpu", dtype=dtype)


def _rows(n, dtype, batch=1, forward=False):
    """compress_apply's inputs (mps, W, conj, tolS, tolV, max_sweeps) of
    every row of the D=8 zip-up stack of the chimera C(n) instance
    (``batch`` copies), captured on the CPU."""
    Wt = torch.cat([_solver(droplet_J(n), n, dtype)._context().Wt] * batch)
    rows, orig = [], bmps.compress_apply

    def capture(mps, W, Dmax, *, conj, tolS, tolV, max_sweeps, rsvd=True,
                omega=None):
        rows.append((bmps.MPS(mps.A.clone(), mps.lognorm.clone()), W.clone(),
                     conj, tolS, tolV, max_sweeps))
        return orig(mps, W, Dmax, conj=conj, tolS=tolS, tolV=tolV,
                    max_sweeps=max_sweeps, rsvd=rsvd, omega=omega)

    bmps.compress_apply = capture
    try:
        build = engine.build_rhoB if forward else engine.build_rhoT
        build(Wt, Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20)
    finally:
        bmps.compress_apply = orig
    return rows


def _three_steps(mps, W, conj, tolS):
    """compress_apply's steps before the polish as its code read before
    K6 (tolS already at least eps)."""
    mps, _ = bmps.canonize_right(mps)
    out, disc = bmps.zipup_apply(mps, W, 16, conj=conj, tol=tolS / 10,
                                 rsvd=True, omega=None)
    out, disc2 = bmps.canonize_right(out, compress=True, cap=8, tol=tolS)
    disc = torch.maximum(disc, disc2)
    out = bmps.slice_bond(out, 8)
    return mps, out, disc


def _sketch(L, dtype):
    return bmps.sketch_omega(L, 128, 48, dtype, torch.device("cpu"))


@pytest.mark.parametrize("forward", [False, True], ids=["rhoT", "rhoB"])
def test_zipup_row_on_cpu_is_the_three_steps(forward):
    """The wrapper on CPU tensors runs the plain three steps, bit for bit
    what compress_apply ran before K6, and counts no launch; the whole
    absorption (the polish after them) is unchanged too."""
    rows = _rows(4, torch.float32, batch=2, forward=forward)
    before = kernels.zipup_row.launches
    for mps, W, conj, tolS, tolV, ms in rows:
        tolS = max(tolS, torch.finfo(torch.float32).eps)
        Wc = bmps._orient_mpo(W, conj)
        omega = _sketch(mps.A.shape[1], torch.float32)
        assert not zipup.engages(mps.A, Wc, omega)
        got = kernels.zipup_row(mps.A, mps.lognorm, Wc, omega, tolS=tolS)
        phi, out, disc = _three_steps(mps, W, conj, tolS)
        for a, b in zip(got, (phi.A, phi.lognorm, out.A, disc)):
            assert torch.equal(a, b)
        whole = bmps.compress_apply(mps, W, 8, conj=conj, tolS=tolS,
                                    tolV=tolV, max_sweeps=ms)
        want = bmps.variational_implicit(
            out._replace(lognorm=phi.lognorm), phi.A, W, conj=conj,
            tol=max(tolV, 32 * torch.finfo(torch.float32).eps),
            max_sweeps=ms)
        assert torch.equal(whole[0].A, want[0].A)
        assert torch.equal(whole[0].lognorm, want[0].lognorm)
        assert torch.equal(whole[2], disc)
    assert kernels.zipup_row.launches == before


@pytest.fixture
def k6_on_the_cpu(monkeypatch):
    """K6's branch of compress_apply on CPU tensors: ``engages`` says yes
    to the rows it is built for (bond 8, with the sketch), and the
    launch runs the plain steps (the wrapper on CPU tensors) and counts
    its rows."""
    calls = []
    orig = zipup.zipup_row

    def counted(A, lognorm, Wc, omega, *, tolS):
        calls.append(A.shape)
        return orig(A, lognorm, Wc, omega, tolS=tolS)

    monkeypatch.setattr(zipup, "engages",
                        lambda A, Wc, omega: zipup._shapes_fit(A, Wc, omega))
    monkeypatch.setattr(zipup, "zipup_row", counted)
    return calls


@pytest.mark.parametrize("n", [2, 4])
def test_recording_clock_counts_k6_rows(k6_on_the_cpu, n):
    """A recording clock over K6 rows: ``#zipup_k6`` counts the rows, as
    ``#rows`` does, and the ladder's result is the plain one."""
    st = {}
    ins = _solver(droplet_J(n), n)
    ins.precondition(path="device", stage_times=st)
    rows = 2 * n
    assert len(k6_on_the_cpu) == rows
    assert st["ladder/build#rows"] == st["ladder/build#zipup_k6"] == rows
    plain = _solver(droplet_J(n), n)
    plain.precondition(path="device")
    for k, v in ins._gauges.items():
        assert torch.equal(v, plain._gauges[k])
    assert (ins.overlaps_ud == plain.overlaps_ud).all()


def test_k6_branch_waits_for_nothing(k6_on_the_cpu, monkeypatch):
    """The K6 branch neither synchronizes nor reads a device value, with
    or without a recording clock: unrecorded only the launch runs;
    recorded, the row's counter is all it adds. Its absorption equals the
    plain branch's bit for bit on the CPU."""
    def no_wait(*args, **kw):
        raise AssertionError("waited for the device")

    (mps, W, conj, tolS, tolV, ms), = _rows(2, torch.float64)[:1]
    monkeypatch.setattr(bmps, "_sync", no_wait)
    monkeypatch.setattr(config.StageClock, "read", no_wait)
    Wc = bmps._orient_mpo(W, conj)
    omega = _sketch(mps.A.shape[1], torch.float64)
    assert config.recording() is None
    before = len(k6_on_the_cpu)
    phi, out, disc = bmps._zipup_k6(mps, Wc, omega, tolS)
    assert len(k6_on_the_cpu) == before + 1
    st = {}
    with config.StageClock(st, torch.device("cpu")) as clock:
        again = bmps._zipup_k6(mps, Wc, omega, tolS)
        assert clock.counters == {"zipup_k6": 1}
    want = bmps.zipup_truncate(mps, Wc, 8, tolS=tolS, omega=omega)
    for got in ((phi, out, disc), again):
        assert torch.equal(got[0].A, want[0].A)
        assert torch.equal(got[0].lognorm, want[0].lognorm)
        assert torch.equal(got[1].A, want[1].A)
        assert torch.equal(got[2], want[2])


def _shapes(B=2, L=16, D=8, d=16, lh=16, du=16, n=128, k=48, L_om=None):
    return (torch.empty((B, L, D, d, D), device="meta"),
            torch.empty((B, L, lh, d, lh, du), device="meta"),
            torch.empty((L if L_om is None else L_om, n, k), device="meta"))


@pytest.mark.parametrize("kw, fits", [
    (dict(), True), (dict(L=1), True), (dict(L=8, B=16), True),
    (dict(L=17), False), (dict(D=48), False), (dict(D=16), False),
    (dict(d=4, lh=4, du=4), False), (dict(lh=8), False),
    (dict(du=8), False), (dict(k=32), False), (dict(n=256), False),
    (dict(L_om=15), False)],
    ids=["ladder_c2048", "one_site", "ladder_fleet", "17_sites",
         "boundary_D48", "bond_16", "legs_4", "mpo_8", "up_leg_8",
         "sketch_rank_32", "sketch_rows_256", "sketch_sites"])
def test_k6_envelope(kw, fits):
    """K6 takes the bond of 8 and legs of 16 on 1 to 16 sites with the
    sketch (L, 128, 48): the ladder's rows on chimera; the D=48 boundary
    and every other shape keep the plain steps."""
    assert zipup._shapes_fit(*_shapes(**kw)) is fits
    assert not zipup.engages(*_shapes(**kw))    # not on a card


def test_k6_envelope_needs_the_sketch_and_float32_on_a_card():
    """Without the sketch (``rsvd=False``) K6 does not engage; the sketch
    bmps resolves at the ladder's shapes is (L, 128, 48), at the D=48
    boundary's another; float64 and CPU tensors never engage."""
    A, Wc, omega = _shapes()
    assert not zipup._shapes_fit(A, Wc, None)
    assert not zipup.engages(A, Wc, None)
    assert not zipup._shapes_fit(A[:1], Wc, omega)     # lanes differ
    cpu = [torch.zeros(t.shape, dtype=torch.float32)
           for t in _shapes(L=2)]
    for dtype in (torch.float32, torch.float64):
        ts = [t.to(dtype) for t in cpu]
        assert zipup._shapes_fit(*ts) and not zipup.engages(*ts)
    sk = bmps._zipup_sketch(cpu[0], cpu[1], 16, True, None)
    assert tuple(sk.shape) == (2, 128, 48) and zipup._shapes_fit(*cpu[:2], sk)
    assert bmps._zipup_sketch(cpu[0], cpu[1], 16, False, None) is None
    A48 = torch.zeros((1, 2, 48, 16, 48))
    W48 = torch.zeros((1, 2, 16, 16, 16, 16))
    assert tuple(bmps._zipup_sketch(A48, W48, 96, True, None).shape) \
        == (2, 768, 128)


def test_zipup_row_refuses_devices_it_does_not_take():
    """The wrapper runs the plain steps only when every tensor is on the
    CPU: a device that is not CUDA, or tensors on two devices, raise."""
    meta = _shapes(L=2)
    (mps, W, conj, tolS, _, _), = _rows(2, torch.float64)[:1]
    Wc = bmps._orient_mpo(W, conj)
    before = kernels.zipup_row.launches
    for args in ((meta[0], torch.zeros(2, device="meta"), meta[1], meta[2]),
                 (mps.A, mps.lognorm, Wc, meta[2])):
        with pytest.raises(ValueError):
            kernels.zipup_row(*args, tolS=tolS)
    assert kernels.zipup_row.launches == before
