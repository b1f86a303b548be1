"""The boundary's SVDs and K7 (``kernels.svd``) on the CPU: the envelope
of matrices K7 takes; CPU tensors take ``torch.linalg``, bit for bit what
``bmps`` ran before K7, and launch nothing; every SVD of a row absorption
goes through ``bmps.svd_fixed`` or ``bmps.svdvals``, which a recording
clock counts as ``#svd_k7`` with the branch forced on the CPU, and that
the branch waits for nothing. The kernel itself runs only on the card
(tests/test_torch_gpu.py)."""

import pytest
import torch

import tnax_torch as tt
from tnax_torch import bmps, config, engine, kernels
from tnax_torch.kernels import svd as k7
from torch_helpers import droplet_J


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("shape", [
    (1, 128, 768), (8, 128, 768), (1, 96, 96), (8, 96, 96), (1, 48, 48),
    (8, 48, 48), (1, 96, 512), (8, 96, 512), (1, 64, 64), (8, 64, 64),
    (1, 32, 32), (8, 32, 32), (16, 16, 16), (2, 48, 128), (2, 256, 128),
    (1, 1, 1), (3, 4, 2, 5), (1, 4096, 128), (1, 128, 4096)],
    ids=lambda s: "x".join(map(str, s)))
def test_k7_envelope_takes(shape):
    """The boundary's shapes at Dmax 48 (the zip-up's core 128 x 768, the
    truncation 96 x 96, the polish 48 x 48) and 32 (96 x 512, 64 x 64,
    32 x 32), at B = 1 and 8, and smaller or batched ones, either way
    round, fit; on no card does K7 engage."""
    assert k7._shapes_fit(shape)
    assert k7._shapes_fit(shape[:-2] + shape[:-3:-1])
    assert not k7.engages(_meta(*shape))


@pytest.mark.parametrize("shape", [
    (1, 1536, 768), (1, 160, 1024), (1, 129, 129), (1, 129, 4096),
    (1, 1, 4097), (0, 48, 48), (1, 0, 4), (48,)],
    ids=["exact_zipup_D48", "core_D64", "p129", "p129_wide", "q4097",
         "no_matrix", "empty", "vector"])
def test_k7_envelope_refuses(shape):
    """The exact zip-up (rsvd=False, 1536 x 768), the core at Dmax 64, any
    min(m, n) above 128 or max(m, n) above 4096, and empty batches keep
    torch.linalg."""
    assert not k7._shapes_fit(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_never_engages_on_the_cpu(dtype):
    """CPU tensors never engage, float32 or float64, though their shapes
    fit; float64 never engages whatever its device (the rule is dtype,
    device and shape alone)."""
    M = torch.zeros((2, 48, 48), dtype=dtype)
    assert k7._shapes_fit(M.shape) and not k7.engages(M)
    assert not k7.engages(_meta(2, 48, 48).double())


@pytest.mark.parametrize("shape", [(3, 48, 48), (2, 40, 96), (2, 96, 40),
                                   (5, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrappers_are_torch_linalg(shape, dtype):
    """On CPU tensors the wrappers and bmps run torch.linalg with
    svd_fixed's sign rule, bit for bit as bmps did before K7, and count
    no launch."""
    M = torch.randn(shape, dtype=dtype,
                    generator=torch.Generator().manual_seed(3))
    before = kernels.launch_counts()["svd"]
    U, S, Vh = torch.linalg.svd(M, full_matrices=False)
    flip = (U.amin(-2).abs() > U.amax(-2)) & (Vh.amin(-1).abs() > Vh.amax(-1))
    s = torch.where(flip, -1.0, 1.0).to(dtype)
    want = (U * s[..., None, :], S, Vh * s[..., :, None])
    for got in (bmps.svd_fixed(M), kernels.svd_fixed(M),
                kernels.svd_fixed_plain(M)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    vals = torch.linalg.svdvals(M)
    for got in (bmps.svdvals(M), kernels.svdvals(M)):
        assert torch.equal(got, vals)
    assert kernels.launch_counts()["svd"] == before


def test_wrappers_refuse_devices_they_do_not_take():
    """A device that is neither the CPU nor CUDA raises, and counts no
    launch."""
    before = kernels.launch_counts()["svd"]
    for fn in (kernels.svd_fixed, kernels.svdvals):
        with pytest.raises(ValueError):
            fn(_meta(2, 48, 48))
    assert kernels.launch_counts()["svd"] == before


@pytest.fixture
def k7_on_the_cpu(monkeypatch):
    """K7's branch of bmps on CPU tensors: ``engages`` says yes to every
    shape in the envelope, and the launches run the plain versions (the
    wrappers on CPU tensors) and count their matrices' shapes."""
    calls = []
    svd, vals = k7.svd_fixed, k7.svdvals

    def counted_svd(M):
        calls.append(("svd", tuple(M.shape)))
        return svd(M)

    def counted_vals(M):
        calls.append(("vals", tuple(M.shape)))
        return vals(M)

    monkeypatch.setattr(k7, "engages", lambda M: k7._shapes_fit(M.shape))
    monkeypatch.setattr(k7, "svd_fixed", counted_svd)
    monkeypatch.setattr(k7, "svdvals", counted_vals)
    return calls


def _boundary(Dmax, stage_times=None):
    """The chimera C(3) instance's boundary stack at Dmax on the CPU in
    float64, built as the search builds it, under a recording clock."""
    ins = tt.Solver(mode="Ising", Nx=3, Ny=3, Nc=8, beta=3, J=droplet_J(3),
                    device="cpu", dtype=torch.float64)
    with config.StageClock(stage_times, torch.device("cpu")) as clock:
        rhoT, _, overlaps, disc = engine.build_rhoT(
            ins._context().Wt, Dmax=Dmax, tolS=1e-16, tolV=1e-10,
            max_sweeps=20)
        clock.lap("boundary")
    return rhoT, overlaps, disc


@pytest.mark.parametrize("Dmax", [8, 16])
def test_recording_clock_counts_every_boundary_svd(k7_on_the_cpu, Dmax):
    """Every SVD of the boundary's rows goes through K7's branch: per row
    one SVD a site in the zip-up and one in the truncation sweep, and the
    polish's singular values, 2 L - 1 a pass. ``#svd_k7`` counts them,
    and the stack is the plain branch's bit for bit."""
    st = {}
    got = _boundary(Dmax, st)
    L, rows, passes = 3, st["boundary#rows"], st["boundary#passes"]
    assert rows == 3
    assert st["boundary#svd_k7"] == len(k7_on_the_cpu) \
        == rows * 2 * L + passes * (2 * L - 1)
    assert sum(kind == "vals" for kind, _ in k7_on_the_cpu) \
        == passes * (2 * L - 1)
    k7_on_the_cpu.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k7, "engages", lambda M: False)
        want = _boundary(Dmax)
    assert not k7_on_the_cpu
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k7_branch_waits_for_nothing(k7_on_the_cpu, monkeypatch):
    """The K7 branch neither synchronizes nor reads a device value, with
    or without a recording clock: unrecorded only the launch runs;
    recorded, the call's counter is all it adds."""
    def no_wait(*args, **kw):
        raise AssertionError("waited for the device")

    monkeypatch.setattr(bmps, "_sync", no_wait)
    monkeypatch.setattr(config.StageClock, "read", no_wait)
    M = torch.randn((2, 96, 96), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    assert config.recording() is None
    bmps.svd_fixed(M)
    bmps.svdvals(M[:, :48, :48])
    assert len(k7_on_the_cpu) == 2
    with config.StageClock({}, torch.device("cpu")) as clock:
        bmps.svd_fixed(M)
        bmps.svdvals(M[:, :48, :48])
        bmps.truncate_center(M, 48, 1e-16)
        assert clock.counters == {"svd_k7": 3}
