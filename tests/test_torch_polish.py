"""The variational polish's dispatch to K5 (``kernels.polish``) on the
CPU: CPU tensors take the plain polish and launch nothing; the plain
stop loop run on a batch of lanes equals each lane run alone (the
semantics K5 implements, one block per lane); the stage clock's
counters of a K5 row (``#polish_k5``, ``#passes``, ``#variational_s``);
and the envelope of shapes K5 takes. The kernel itself runs only on the
card (tests/test_torch_gpu.py)."""

import pytest
import torch

import tnax_torch as tt
from tnax_torch import bmps, config, engine, kernels
from tnax_torch.kernels import polish
from torch_helpers import droplet_J


def _solver(J, n, dtype=torch.float64):
    return tt.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, beta=3, J=J,
                     device="cpu", dtype=dtype)


def _rows(n, dtype, batch=1, forward=False, seeds=None):
    """The polish inputs (A0, phi_A, Wc, tol, max_sweeps) of every row of
    the D=8 zip-up stack of chimera C(n) instances (``batch`` copies, or
    one instance per seed), captured on the CPU."""
    Js = [droplet_J(n, s) for s in seeds] if seeds else [droplet_J(n)] * batch
    Wt = torch.cat([_solver(J, n, dtype)._context().Wt for J in Js])
    rows, orig = [], bmps.variational_implicit

    def capture(mps, phi_A, W, *, conj, tol, max_sweeps):
        rows.append((mps.A.clone(), phi_A.clone(),
                     bmps._orient_mpo(W, conj).clone(), tol, max_sweeps))
        return orig(mps, phi_A, W, conj=conj, tol=tol, max_sweeps=max_sweeps)

    bmps.variational_implicit = capture
    try:
        build = engine.build_rhoB if forward else engine.build_rhoT
        build(Wt, Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20)
    finally:
        bmps.variational_implicit = orig
    return rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 4])
def test_cpu_ladder_takes_the_plain_path(n, dtype):
    """The device ladder and the boundary on the CPU, at K5's shapes in
    float32 as well: no K5 launch, no ``#polish_k5`` counter, and the
    passes counted by the plain loop."""
    ins = _solver(droplet_J(n), n, dtype)
    before = kernels.polish_row.launches
    st = {}
    ins.precondition(path="device", stage_times=st)
    ins.search_ground_state(path="device", stage_times=st, M=32,
                            relative_P_cutoff=1e-8, Dmax=8)
    assert kernels.polish_row.launches == before
    assert not any(k.endswith("#polish_k5") for k in st)
    assert st["ladder/build#passes"] >= st["ladder/build#rows"] == 2 * n


@pytest.mark.parametrize("forward", [False, True], ids=["rhoT", "rhoB"])
def test_polish_row_on_cpu_is_the_plain_polish(forward):
    """The wrapper on CPU tensors runs the plain polish, bit for bit, and
    counts no launch; variational_implicit on CPU tensors never reaches
    the wrapper."""
    rows = _rows(4, torch.float32, batch=2, forward=forward)
    before = kernels.polish_row.launches
    for A0, phi_A, Wc, tol, ms in rows:
        assert not polish.engages(A0, phi_A, Wc)
        got = kernels.polish_row(A0, phi_A, Wc, tol=tol, max_sweeps=ms)
        want = bmps.variational_implicit_plain(A0, phi_A, Wc, tol=tol,
                                               max_sweeps=ms)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert kernels.polish_row.launches == before


@pytest.mark.parametrize("case", ["c128_rhoT", "c128_rhoB", "c72_fleet"])
def test_batched_stop_loop_equals_each_lane_alone(case):
    """The plain stop loop over a batch of lanes (a stopped lane keeps
    its state while the others sweep on) ends every lane where the lane
    alone ends: the same sweeps, and its A, overlap and ln_state, in
    float64. K5 runs each lane alone, in its own block."""
    if case == "c72_fleet":
        rows = _rows(3, torch.float64, seeds=(1, 2, 3, 4))
    else:
        rows = _rows(4, torch.float64, batch=2, forward=case == "c128_rhoB")
    lanes_differ = False
    for A0, phi_A, Wc, tol, ms in rows:
        A, ov, ln, sw = bmps.variational_implicit_plain(
            A0, phi_A, Wc, tol=tol, max_sweeps=ms)
        lanes_differ |= len(set(sw.tolist())) > 1
        for z in range(A0.shape[0]):
            s = slice(z, z + 1)
            a, o, l_, w = bmps.variational_implicit_plain(
                A0[s], phi_A[s], Wc[s], tol=tol, max_sweeps=ms)
            assert int(w) == int(sw[z])
            torch.testing.assert_close(a, A[s], rtol=1e-9, atol=1e-12)
            torch.testing.assert_close(o, ov[s], rtol=1e-9, atol=0)
            torch.testing.assert_close(l_, ln[s], rtol=0, atol=1e-9)
    if case == "c72_fleet":
        assert lanes_differ


@pytest.mark.parametrize("ms", [1, 2, 3])
def test_stop_loop_runs_each_lane_to_its_own_stop(ms):
    """At a max_sweeps the lanes reach, every lane runs exactly
    min(its own stop, max_sweeps) passes."""
    rows = _rows(2, torch.float64, seeds=(1, 2, 3))
    for A0, phi_A, Wc, tol, _ in rows:
        free = bmps.variational_implicit_plain(A0, phi_A, Wc, tol=tol,
                                               max_sweeps=20)[3]
        capped = bmps.variational_implicit_plain(A0, phi_A, Wc, tol=tol,
                                                 max_sweeps=ms)[3]
        assert torch.equal(capped, torch.clamp(free, max=ms))


@pytest.fixture
def k5_on_the_cpu(monkeypatch):
    """K5's branch of variational_implicit on CPU tensors: ``engages``
    says yes, and the launch is a stand-in that runs the plain polish
    unrecorded and keeps each row's sweeps."""
    calls = []

    def stand_in(A0, phi_A, Wc, *, tol, max_sweeps):
        token = config._RECORDING.set(None)
        try:
            out = bmps.variational_implicit_plain(A0, phi_A, Wc, tol=tol,
                                                  max_sweeps=max_sweeps)
        finally:
            config._RECORDING.reset(token)
        calls.append(out[3].clone())
        return out

    monkeypatch.setattr(polish, "engages", lambda *ts: True)
    monkeypatch.setattr(polish, "polish_row", stand_in)
    return calls


@pytest.mark.parametrize("n", [2, 4])
def test_recording_clock_counts_k5_rows(k5_on_the_cpu, n):
    """A recording clock over K5 rows: ``#polish_k5`` counts the rows,
    ``#passes`` adds each row's most sweeps (one read after the launch),
    ``#variational_s`` the seconds from the read before the launch to
    that read, and ``#wait_s`` the two reads."""
    ins = _solver(droplet_J(n), n)
    st = {}
    ins.precondition(path="device", stage_times=st)
    rows = 2 * n
    assert len(k5_on_the_cpu) == rows
    assert st["ladder/build#rows"] == st["ladder/build#polish_k5"] == rows
    assert st["ladder/build#passes"] == sum(int(s.max())
                                            for s in k5_on_the_cpu)
    assert 0 < st["ladder/build#variational_s"] <= st["ladder/build"]
    assert st["ladder/build#wait_s"] > 0


def test_unrecorded_k5_branch_waits_for_nothing(k5_on_the_cpu, monkeypatch):
    """Without a recording clock the K5 branch neither synchronizes nor
    reads a device value: only the launch runs."""
    def no_sync(device):
        raise AssertionError("synchronized without a recording clock")

    monkeypatch.setattr(bmps, "_sync", no_sync)
    assert config.recording() is None
    (A0, phi_A, Wc, tol, ms), = _rows(2, torch.float64)[:1]
    mps = bmps.MPS(A=A0, lognorm=torch.zeros(A0.shape[0], dtype=A0.dtype))
    before = len(k5_on_the_cpu)
    out, overlap, sweeps = bmps.variational_implicit(
        mps, phi_A, Wc, conj=True, tol=tol, max_sweeps=ms)
    assert len(k5_on_the_cpu) == before + 1
    want = bmps.variational_implicit_plain(A0, phi_A, Wc, tol=tol,
                                           max_sweeps=ms)
    assert torch.equal(out.A, want[0]) and torch.equal(sweeps, want[3])
    assert torch.equal(out.lognorm, mps.lognorm + want[2])


def _shapes(B=2, L=16, Dn=8, du=16, Do=8, dp=16, lh=16):
    return (torch.empty((B, L, Dn, du, Dn), device="meta"),
            torch.empty((B, L, Do, dp, Do), device="meta"),
            torch.empty((B, L, lh, dp, lh, du), device="meta"))


@pytest.mark.parametrize("kw, fits", [
    (dict(), True), (dict(L=1), True), (dict(L=8, B=16), True),
    (dict(L=17), False), (dict(Dn=48, Do=48), False), (dict(Dn=32), False),
    (dict(Do=16), False), (dict(du=4, dp=4, lh=4), False),
    (dict(lh=8), False)],
    ids=["ladder_c2048", "one_site", "ladder_fleet", "17_sites",
         "boundary_D48", "new_bond_32", "old_bond_16", "legs_4", "mpo_8"])
def test_k5_envelope(kw, fits):
    """K5 takes bonds of 8 and legs of 16 on 1 to 16 sites: the ladder's
    rows on chimera; the D=48 boundary and every other shape keep the
    plain polish."""
    assert polish._shapes_fit(*_shapes(**kw)) is fits
    assert not polish.engages(*_shapes(**kw))    # not on a card


def test_k5_envelope_needs_one_lane_count():
    A0, phi_A, Wc = _shapes()
    assert not polish._shapes_fit(A0[:1], phi_A, Wc)
    assert not polish._shapes_fit(A0, phi_A[:, :8], Wc)


def test_polish_row_refuses_devices_it_does_not_take():
    """The wrapper runs the plain polish only when every tensor is on the
    CPU: a device that is not CUDA, or tensors on two devices, raise."""
    meta = _shapes()
    (A0, phi_A, Wc, tol, ms), = _rows(2, torch.float64)[:1]
    before = kernels.polish_row.launches
    for args in (meta, (A0, phi_A, meta[2])):
        with pytest.raises(ValueError):
            kernels.polish_row(*args, tol=tol, max_sweeps=ms)
    assert kernels.polish_row.launches == before
