"""K4 ``sample_site`` and K1's plain version on the CPU, in float64, at a
small size (a few walkers, Np = 16, D = 8 and D = 12 > lv): the plain
version of K4 against the composition it replaces, the sampler's rows
through it against tnax's ``sample_rows`` (a fleet of two with ragged
valid-state counts), the launches of the sampler's site loop, and K1's
plain version on badly balanced matrices of order 9, 16 and 32. Inputs
are made with numpy from seeds."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from tnax import parallel as jpar
from tnax import precondition as jpre
from tnax_torch import engine, kernels, parallel
from tnax_torch.kernels import sample
from torch_helpers import extreme_gebal, marginal_inputs

NP, LH, LV = 16, 4, 4


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _site_args(rng, B, M, D, nvalids, nx=1, W=4, L=6):
    """sample_site's inputs for B instances: T2 from the two GEMMs, the
    table with the states last, int64 drindex/nvalid, int32 dmap, rmap,
    vind and states, as the sampler holds them."""
    ins = [marginal_inputs(rng, M=M, Np=NP, lh=LH, lv=LV, D=D, nvalid=nv)
           for nv in nvalids]
    lB, drindex, AT, RL, RRsel, lidx, uidx = (
        _t(np.stack(x)) for x in list(zip(*ins))[:7])
    vind = _t(rng.integers(0, LV, size=(B, M, W)).astype(np.int32))
    vind[:, :, nx], vind[:, :, nx + 1] = lidx, uidx
    return dict(
        T2=engine._marginal_T2(AT, RL, RRsel),
        lBT=kernels.marginal.boltzmann_columns(lB), drindex=drindex.long(),
        dmap=_t(rng.integers(0, LV, size=(B, NP)).astype(np.int32)),
        rmap=_t(rng.integers(0, LH, size=(B, NP)).astype(np.int32)),
        nvalid=torch.tensor(nvalids), u=_t(rng.random((B, M))), AT=AT, RL=RL,
        vind=vind, states=_t(rng.integers(0, NP, size=(B, M, L)).astype(
            np.int32)), nx=nx, col=3, mq=torch.full((B,), 0.25,
                                                   dtype=torch.float64))


@pytest.mark.parametrize("D", [8, 12])
def test_sample_site_plain_is_the_old_site_step(D):
    """sample_site_plain equals, bit for bit, the site step the sampler ran
    before K4 took it whole: sample_draw_plain, the state and vind writes,
    the left-environment update with its (B, M, D, D) gather, the min."""
    a = _site_args(np.random.default_rng(D), 2, 24, D, (13, 7))
    nx, col = a["nx"], a["col"]
    vind, states, mq = a["vind"].clone(), a["states"].clone(), a["mq"].clone()
    indc, mPn = kernels.sample_draw_plain(
        a["T2"], a["lBT"], a["drindex"], vind[:, :, nx], vind[:, :, nx + 1],
        a["nvalid"], a["u"])
    ind = indc.long()
    states[:, :, col] = indc
    vind[:, :, nx] = a["dmap"].gather(1, ind)
    vind[:, :, nx + 1] = a["rmap"].gather(1, ind)
    b = torch.arange(2)[:, None]
    new = (a["RL"][:, :, None, :]
           @ a["AT"].permute(0, 2, 1, 3)[b, vind[:, :, nx].long()])[:, :, 0]
    scale = new.abs().amax(dim=2, keepdim=True)
    RL = new / torch.where(scale > 0, scale, 1.0)
    mq = torch.minimum(mq, mPn.amin(dim=1))

    got = {k: a[k] for k in ("vind", "states", "mq")}
    RL_got, mPn_got = kernels.sample_site_plain(
        *(a[k] for k in ("T2", "lBT", "drindex", "dmap", "rmap", "nvalid",
                         "u", "AT", "RL")), got["vind"], got["states"], nx,
        col, got["mq"])
    for k, want in (("vind", vind), ("states", states), ("mq", mq)):
        assert torch.equal(got[k], want), k
    assert torch.equal(RL_got, RL)
    assert torch.equal(mPn_got, mPn)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = kernels.sample_site.launches
    again = _site_args(np.random.default_rng(D), 2, 24, D, (13, 7))
    RL_w, _ = kernels.sample_site(
        *(again[k] for k in ("T2", "lBT", "drindex", "dmap", "rmap",
                             "nvalid", "u", "AT", "RL", "vind", "states",
                             "nx", "col", "mq")))
    assert torch.equal(RL_w, RL) and torch.equal(again["vind"], vind)
    assert kernels.sample_site.launches == before


def _uniforms(key, n_sites, M):
    """tnax's per-site uniforms of a sampling row drawn from ``key``
    (parallel.py:1296-1297): (n_sites, M) float64."""
    out = []
    for _ in range(n_sites):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (M,), jnp.float64)))
    return np.stack(out)


@pytest.mark.parametrize("D", [8, 12])
def test_sample_rows_fleet_matches_tnax(D):
    """Two lattice rows of two sites, a fleet of two instances whose valid
    state counts differ per site, through the port's sample_rows (K4's
    plain version) and tnax's sample_rows per instance under the same
    draws: walkers, left environments and the row minimum of mPn agree."""
    rng = np.random.default_rng(50 + D)
    Nx, Mw = 2, 20
    nvalids = ((13, 16), (5, 9))          # (instance, site)
    rows = []
    for ny in range(2):
        sites = [[marginal_inputs(rng, M=Mw, Np=NP, lh=LH, lv=LV, D=D,
                                  nvalid=nv) for nv in nvs]
                 for nvs in nvalids]
        rows.append(dict(
            lB=np.stack([[s[0] for s in inst] for inst in sites]),
            drindex=np.stack([[s[1] for s in inst] for inst in sites]),
            AT=np.stack([[s[2] for s in inst] for inst in sites]),
            RRs=np.stack([[s[4] for s in inst] for inst in sites]),
            nvalid=np.array(nvalids, np.int64),
            dmap=rng.integers(0, LV, size=(2, Nx, NP)).astype(np.int32),
            rmap=rng.integers(0, LH, size=(2, Nx, NP)).astype(np.int32),
            cols=np.array([ny * Nx, ny * Nx + 1], np.int32)))
    RL0 = rng.standard_normal((2, Mw, D))
    vind0 = np.zeros((2, Mw, Nx + 1), np.int32)
    states0 = np.zeros((2, Mw, 2 * Nx), np.int32)
    keys = [jax.random.PRNGKey(7 + b) for b in range(2)]
    want = [dict(RL=jnp.asarray(RL0[b]), vind=jnp.asarray(vind0[b]),
                 states=jnp.asarray(states0[b])) for b in range(2)]
    got = dict(RL=_t(RL0), vind=_t(vind0), states=_t(states0))
    for row in rows:
        u = np.stack([_uniforms(k, Nx, Mw) for k in keys])
        mq_want = []
        for b in range(2):
            rb = {k: jnp.asarray(v if k == "cols" else v[b])
                  for k, v in row.items()}
            want[b], _, mq_b = jpar.sample_rows(want[b], rb, keys[b], M=Mw,
                                                Nx=Nx)
            mq_want.append(float(mq_b))
        rowt = {k: _t(v) for k, v in row.items() if k not in ("cols", "lB")}
        rowt["drindex"] = rowt["drindex"].long()
        rowt["lBT"] = kernels.marginal.boltzmann_columns(_t(row["lB"]))
        rowt["cols"] = row["cols"].tolist()
        got, mq = parallel.sample_rows(got, rowt, _t(u), M=Mw, Nx=Nx)
        for b in range(2):
            for k in ("vind", "states"):
                assert np.array_equal(got[k][b].numpy(),
                                      np.asarray(want[b][k])), (b, k)
            np.testing.assert_allclose(got["RL"][b].numpy(),
                                       np.asarray(want[b]["RL"]), rtol=1e-10,
                                       atol=1e-13)
            assert float(mq[b]) == pytest.approx(mq_want[b], rel=1e-10,
                                                 abs=1e-14)
        keys = [jax.random.fold_in(k, 1) for k in keys]


class _Ops(TorchDispatchMode):
    """Counts the aten operations that are not views."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_site_loop_runs_two_gemms_and_k4(monkeypatch):
    """Per site the sampler runs the two GEMMs of the marginals and K4,
    and nothing else: the operations of a row of 4 sites exceed those of a
    row of 2 by 4 bmm and 2 K4 calls. A fleet of two, so that a site's
    right environments are one contiguous slice of the row's stack."""
    rng = np.random.default_rng(5)
    B, Mw, D = 2, 12, 8
    ops = _Ops()

    def k4(*args):
        ops.ops["K4"] += 1
        with _disable_current_modes():
            return sample.sample_site(*args)
    monkeypatch.setattr(parallel, "sample_site", k4)

    def run(Nx):
        AT = _t(rng.standard_normal((B, Nx, D, LV, D)))
        Wt = _t(rng.random((B, Nx, LH, LV, LH, LV)))
        vind = _t(rng.integers(0, LV, size=(B, Mw, Nx + 1)).astype(np.int32))
        row = dict(
            lBT=_t(-rng.random((B, Nx, LH, LV, NP))),
            drindex=_t(rng.integers(0, LH * LV, size=(B, Nx, NP))),
            AT=AT, RRs=engine.row_right_envs(AT, Wt, vind[:, :, 1:]),
            dmap=_t(rng.integers(0, LV, size=(B, Nx, NP)).astype(np.int32)),
            rmap=_t(rng.integers(0, LH, size=(B, Nx, NP)).astype(np.int32)),
            nvalid=torch.full((B, Nx), NP), cols=list(range(Nx)))
        beam = dict(RL=_t(rng.standard_normal((B, Mw, D))), vind=vind,
                    states=torch.zeros((B, Mw, Nx), dtype=torch.int32))
        u = _t(rng.random((B, Nx, Mw)))
        ops.ops.clear()
        with ops:
            parallel.sample_rows(beam, row, u, M=Mw, Nx=Nx)
        return collections.Counter(ops.ops)

    two, four = run(2), run(4)
    assert four - two == collections.Counter({"aten.bmm": 4, "K4": 2})
    assert two - four == collections.Counter()


@pytest.mark.parametrize("n", [9, 16, 32])
def test_gebal_plain_extreme_matches_scipy_and_tnax(n):
    """K1's plain version on badly balanced n x n matrices (a similarity
    scaling whose entries span 2^-50 .. 2^50, a zero row and a zero
    column, nd < n for two): bit for bit scipy's and tnax's scales."""
    As, nds = extreme_gebal(np.random.default_rng(n), n)
    got = kernels.gebal_scale_plain(_t(As), _t(nds), 1e30).numpy()
    for b, nd in enumerate(nds):
        _, (want, _) = scipy.linalg.matrix_balance(
            As[b, :nd, :nd], permute=False, separate=True)
        assert np.array_equal(got[b, :nd], want), b
        assert (got[b, nd:] == 1.0).all()
        ref = np.asarray(jpre.gebal_scale(jnp.asarray(As[b]),
                                          jnp.asarray(nd), 1e30))
        assert np.array_equal(got[b], ref), b
    assert got.max() / got.min() >= 2.0 ** 40     # it had work to do

