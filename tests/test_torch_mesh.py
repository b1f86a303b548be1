"""The port's device mesh on torch.distributed, in float64 on the CPU:
eight gloo ranks, spawned once, run the beam-sharded row step and the
sharded search on a (2, 4) mesh, the data-parallel fleet search on
(8, 1) and the data-parallel fleet sampler on (4, 2). The parent process
holds the results against tnax's sharded functions (on the 8 virtual
devices of tests/conftest.py) and the port's unsharded ones. The ranks
import this module by name, so it imports tnax only inside the
parent's functions."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tnax_torch as tt
from tnax_torch import interop, parallel
from tnax_torch.kernels import marginal
from torch_helpers import spawn

WORLD = 8
M = 64
ROW = dict(Nx=4, min_dEng=1e-12, log2_cutoff=-40.0)
SEARCH = dict(M=M, relative_P_cutoff=1e-12, Dmax=8)


def _solvers(Js, Nx, Ny, Nc, beta):
    return [tt.Solver(mode="Ising", Nx=Nx, Ny=Ny, Nc=Nc, beta=beta, J=J,
                      device="cpu") for J in Js]


def _local(x, mesh, *axes):
    """This rank's block of a global (B, M, ...) tensor along ``axes``."""
    for dim, name in enumerate(axes):
        x = x.narrow(dim, mesh.block(x.shape[dim], name).start,
                     x.shape[dim] // mesh.shape[name])
    return x


def _ranks(rank, store, out, inputs):
    """One rank: every mesh check, its results saved to out/r<rank>.pt."""
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=WORLD, rank=rank)
    inp = torch.load(inputs, weights_only=False)
    res = {}

    mesh = parallel.make_mesh(2, 4)
    beam = {k: _local(v, mesh, "data", "beam")
            for k, v in inp["beam"].items()}
    row = {k: v if k == "cols" else _local(v, mesh, "data")
           for k, v in inp["row"].items()}
    step = parallel.sharded_row_step(mesh, M=M, bits=inp["bits"], **ROW)
    res["row"] = step(beam, row)
    ctxs = [s._context() for s in _solvers(inp["Js_search"], 3, 3, 2, 1.5)]
    res["search"] = parallel.sharded_search_gs(ctxs, mesh, zipup_rsvd=False,
                                               **SEARCH)
    res["errors"] = []
    for kw in (dict(ctxs=ctxs[:1] * 3, mesh=mesh, M=M),
               dict(ctxs=ctxs, mesh=mesh, M=M + 2)):
        try:
            parallel.sharded_search_gs(Dmax=8, **kw)
        except ValueError as e:
            res["errors"].append(str(e))
    try:
        parallel.make_mesh(3, 3)
    except ValueError as e:
        res["errors"].append(str(e))

    mesh = parallel.make_mesh(8, 1)
    ctxs = [s._context() for s in _solvers(inp["Js_multi"], 2, 2, 2, 2.0)]
    res["multi"] = parallel.multi_search_gs(ctxs, mesh=mesh, **SEARCH)
    if rank == 0:
        res["multi_ref"] = parallel.multi_search_gs(ctxs, **SEARCH)

    mesh = parallel.make_mesh(4, 2)
    solvers = _solvers(inp["Js_sample"], 2, 2, 4, 2)
    res["sample"] = tt.multi_flagship_sample(solvers, M=16, Dmax=8, seed=5,
                                             mesh=mesh)
    if rank == 0:
        res["sample_ref"] = tt.multi_flagship_sample(solvers, M=16, Dmax=8,
                                                     seed=5)
    torch.save(res, os.path.join(out, f"r{rank}.pt"))
    dist.destroy_process_group()


def _tnax_rows(ctxs):
    """tnax's row-0 inputs of each context, as its sharded-equivalence
    test builds them (aidx 0 and the right environments of the empty
    beam)."""
    import jax.numpy as jnp
    from tnax import engine as jengine
    from tnax import parallel as jpar
    beams, rows = [], []
    for c in ctxs:
        Nx, Ny, D = c.Nx, c.Ny, c.Dmax
        EsP, EslP, EsuP = jpar._padded_energy_rows(c)
        rows.append(dict(
            lB=c.lB[0], drindex=c.drindex[0], AT=c.rhoT[1],
            RRs=jengine.row_right_envs(c.rhoT[1], c.Wt[0],
                                       jnp.zeros((M, Nx), jnp.int32)),
            Es=EsP[0], Esl=EslP[0], Esu=EsuP[0],
            dmap=jnp.asarray(c.dmap[0]), rmap=jnp.asarray(c.rmap[0]),
            nvalid=jnp.asarray(c.nstates[0], jnp.int32),
            cols=jnp.arange(Nx, dtype=jnp.int32)))
        beams.append(dict(
            RL=jnp.zeros((M, D)).at[:, 0].set(1.0),
            vind=jnp.zeros((M, Nx + 1), jnp.int32),
            states=jnp.zeros((M, Nx * Ny), jnp.int32),
            Eng=jnp.zeros((M,)),
            prob=jnp.full((M,), jpar.NEG).at[0].set(0.0),
            deg=jpar.deg_ones((M,)),
            valid=jnp.zeros((M,), bool).at[0].set(True),
            aidx=jnp.zeros((M,), jnp.int32)))
    return beams, rows


def _port_rows(beams, rows):
    """The same inputs as the port's fleet tensors (B, ...)."""
    beam = interop.beam({k: np.stack([np.asarray(b[k]) for b in beams])
                         for k in beams[0]}, "cpu", torch.float64)

    def st(k, dt=None):
        t = torch.as_tensor(np.stack([np.asarray(r[k]) for r in rows]))
        return t if dt is None else t.to(dt)
    row = dict(lBT=marginal.boltzmann_columns(st("lB")),
               drindex=st("drindex", torch.int64), AT=st("AT"),
               RRs=st("RRs"), Es=st("Es"), Esl=st("Esl"), Esu=st("Esu"),
               dmap=st("dmap", torch.int32), rmap=st("rmap", torch.int32),
               nvalid=st("nvalid", torch.int64),
               cols=np.asarray(rows[0]["cols"]).tolist())
    return beam, row


def _search_Js():
    import tnax
    from test_search_small import make_chimera_like
    Js = []
    for s in range(2):
        J = make_chimera_like(np.random.default_rng(s), 3, 3, 2,
                              field=False)
        Js.append([j for j in tnax.round_Jij(J, 1.0) if j[2] != 0])
    return Js


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the inputs they ran on."""
    import tnax
    from tnax.search import ContractionContext
    from test_search_small import make_chimera_like
    tmp = tmp_path_factory.mktemp("mesh")
    ctxs = [ContractionContext(
        tnax.Solver(mode="Ising", Nx=4, Ny=4, Nc=2, beta=1.5,
                    J=make_chimera_like(np.random.default_rng(s), 4, 4,
                                        2)).problem, 1.5)
        for s in range(2)]
    for c in ctxs:
        c.build_boundary(8, 1e-16, 1e-12, 8, True)
    jbeams, jrows = _tnax_rows(ctxs)
    beam, row = _port_rows(jbeams, jrows)
    bits = max(1, int(np.ceil(np.log2(max(ctxs[0].lh, ctxs[0].lv)))))
    inp = dict(beam=beam, row=row, bits=bits, Js_search=_search_Js(),
               Js_multi=[make_chimera_like(np.random.default_rng(s), 2, 2, 2)
                         for s in range(8)],
               Js_sample=[make_chimera_like(np.random.default_rng(40 + s),
                                            2, 2, 4) for s in range(8)])
    torch.save(inp, tmp / "inputs.pt")
    spawn(_ranks, WORLD, (str(tmp / "store"), str(tmp),
                          str(tmp / "inputs.pt")))
    got = [torch.load(tmp / f"r{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return dict(got=got, inp=inp, jbeams=jbeams, jrows=jrows)


def _gather_rows(got, key):
    """The global beam (2, M, ...) from the eight ranks' row-step shards
    (rank r: data r // 4, beam r % 4)."""
    return torch.cat([torch.cat([got[4 * d + j]["row"][0][key]
                                 for j in range(4)], 1) for d in range(2)])


def _canon(E, p, d, v):
    """A beam's valid branches as a canonical multiset (tnax's
    test_sharded_equiv order)."""
    E, p, d = E[v], p[v], d[v]
    o = np.lexsort((d, np.round(p, 4), np.round(E, 6)))
    return E[o], p[o], d[o]


def _assert_same_beams(a, b):
    for (Ea, pa, da), (Eb, pb, db) in zip(a, b):
        assert len(Ea) == len(Eb)
        np.testing.assert_allclose(Ea, Eb, rtol=0, atol=1e-9)
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-9)
        assert np.array_equal(da, db)


def _port_beams(got):
    out = {k: _gather_rows(got, k).numpy() for k in
           ("Eng", "prob", "deg", "valid")}
    return [_canon(out["Eng"][b], out["prob"][b], out["deg"][b],
                   out["valid"][b]) for b in range(2)]


def test_sharded_row_step_matches_unsharded_row_step(runs):
    beam, row = runs["inp"]["beam"], runs["inp"]["row"]
    want, aux_want = parallel.row_step(beam, row, M=M,
                                       bits=runs["inp"]["bits"], **ROW)
    want = {k: v.numpy() for k, v in want.items()}
    _assert_same_beams(_port_beams(runs["got"]),
                       [_canon(want["Eng"][b], want["prob"][b],
                               want["deg"][b], want["valid"][b])
                        for b in range(2)])
    for r in range(WORLD):
        aux = runs["got"][r]["row"][1]
        d = r // 4
        for k in ("ovf", "cmax"):
            assert int(aux[k][0]) == int(aux_want[k][d]), k
        for k in ("mq", "mqc", "pd"):
            assert float(aux[k][0]) == pytest.approx(float(aux_want[k][d]),
                                                     abs=1e-9), k


def test_sharded_row_step_matches_tnax_sharded_row_step(runs):
    import jax.numpy as jnp
    from tnax import parallel as jpar
    mesh = jpar.make_mesh(2, 4)
    step = jpar.sharded_row_step(mesh, M=M, bits=runs["inp"]["bits"], **ROW)
    jb, jr = runs["jbeams"], runs["jrows"]
    out, aux = step({k: jnp.stack([b[k] for b in jb]) for k in jb[0]},
                    {k: jnp.stack([r[k] for r in jr]) for k in jr[0]})
    deg = interop.deg_decode(out["deg"])
    want = [_canon(np.asarray(out["Eng"][b]), np.asarray(out["prob"][b]),
                   deg[b], np.asarray(out["valid"][b])) for b in range(2)]
    _assert_same_beams(_port_beams(runs["got"]), want)
    for r in range(WORLD):
        got = runs["got"][r]["row"][1]
        d = r // 4
        for k in ("ovf", "cmax"):
            assert int(got[k][0]) == int(aux[k][d]), k
        assert float(got["pd"][0]) == pytest.approx(float(aux["pd"][d]),
                                                    abs=1e-9)


def test_sharded_search_matches_tnax_and_single(runs, monkeypatch):
    import tnax
    from tnax import parallel as jpar
    from tnax.search import ContractionContext
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "0")   # the port's zipup_rsvd
    Js = runs["inp"]["Js_search"]
    want = jpar.sharded_search_gs(
        [ContractionContext(tnax.Solver(mode="Ising", Nx=3, Ny=3, Nc=2,
                                        beta=1.5, J=J).problem, 1.5)
         for J in Js], jpar.make_mesh(2, 4), **SEARCH)
    single = [parallel.device_search_gs(s._context(), zipup_rsvd=False,
                                        **SEARCH)
              for s in _solvers(Js, 3, 3, 2, 1.5)]
    got = runs["got"][0]["search"]
    assert len(got) == 2
    for g, w, s, J, ins in zip(got, want, single, Js,
                               _solvers(Js, 3, 3, 2, 1.5)):
        for ref in (w, s):
            assert g["energy"] == pytest.approx(float(ref["energy"]),
                                                abs=1e-9)
            assert g["degeneracy"] == ref["degeneracy"]
        # the state is the port's unsharded one; on the second instance
        # (degeneracy 10) the port and tnax, sharded or not, return
        # different ones of the degenerate ground states, as their
        # unsharded searches already do, so tnax's is held by energy
        assert np.array_equal(g["states"], s["states"])
        ins.states = np.asarray(g["states"])[None, :][:, ins.order]
        assert tt.energy_Jij(J, ins.binary_states())[0] == pytest.approx(
            float(w["energy"]), abs=1e-9)
        for k in ("merge_overflow", "count_max"):
            assert g[k] == s[k], k


def test_every_rank_returns_every_instance(runs):
    for key in ("search", "multi", "sample"):
        first = runs["got"][0][key]
        for r in range(1, WORLD):
            other = runs["got"][r][key]
            assert len(other) == len(first) == {"search": 2}.get(key, 8)
            for a, b in zip(first, other):
                assert np.array_equal(a["states"], b["states"]), key


def test_mesh_errors_in_ranks(runs):
    errors = runs["got"][0]["errors"]
    assert len(errors) == 3
    assert "data axis" in errors[0]
    assert "beam axis" in errors[1]
    assert "3x3=9 ranks" in errors[2] and "init_process_group" in errors[2]


def test_make_mesh_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torch.multiprocessing.spawn"):
        parallel.make_mesh(2, 4)


def test_data_mesh_search_equals_no_mesh(runs):
    from test_search_small import brute_force_min
    got, want = runs["got"][0]["multi"], runs["got"][0]["multi_ref"]
    assert len(got) == len(want) == 8
    for g, w, J in zip(got, want, runs["inp"]["Js_multi"]):
        assert g["energy"] == w["energy"]
        assert g["degeneracy"] == w["degeneracy"]
        assert np.array_equal(g["states"], w["states"])
        assert g["energy"] == pytest.approx(brute_force_min(J, 8)[0],
                                            abs=1e-9)


def test_data_mesh_sampler_is_bit_identical(runs):
    got, want = runs["got"][0]["sample"], runs["got"][0]["sample_ref"]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert np.array_equal(g["states"], w["states"])
        assert np.array_equal(g["energy"], w["energy"])
