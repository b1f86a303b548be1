"""The port's beam-sharded spectrum on torch.distributed, in float64 on
the CPU: four gloo ranks, spawned once, run sharded_search_spectrum and
one row of sharded_row_records on a (1, 4) mesh. The parent process
holds the decoded states against tnax's sharded_search_spectrum (on the
virtual devices of tests/conftest.py) and the port's single-card
device_search_spectrum, and the records against the port's unsharded
ones. The ranks import this module by name, so it imports tnax only
inside the parent's functions."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tnax_torch as tt
from tnax_torch import parallel, spectrum
from torch_helpers import degenerate_J, spawn

WORLD = 4
SPEC = dict(M=64, relative_P_cutoff=1e-12, Dmax=8, max_dEng=3.0)
DECODE = dict(max_dEng=3.0, max_states=256)
# record fields that do not depend on the order of the candidates
ORDER_FREE = ("out_prob", "out_valid", "n_valid", "count", "disc_cut",
              "disc_m", "minP", "minP_core")


def _solver(J):
    return tt.Solver(mode="Ising", Nx=3, Ny=3, Nc=2, beta=1.5, J=J,
                     device="cpu")


def _records(ctx, M, C, mesh=None):
    """Row 0's records of ``ctx`` at cap C: unsharded, or on this rank's
    block of the branches through ``sharded_row_records`` (each rank caps
    its own candidates at C/4, so at C = M*Np both see every one)."""
    ctx.build_boundary(8, 1e-16, 1e-10, 20, rsvd=False)
    grid_in = parallel.search_inputs(ctx)
    grid_in.pop("cols")
    row = {k: v[:, 0] for k, v in grid_in.items()}
    beam = parallel._initial_beam(1, M, 8, ctx.Nx, ctx.Ny, ctx.dtype, "cpu")
    beam = {k: beam[k] for k in ("vind", "Eng", "prob", "valid")}
    kw = dict(M=M, C=C, Nx=ctx.Nx, bits=2, min_dEng=1e-12,
              log2_cutoff=-40.0)
    if mesh is None:
        _, rec = parallel.row_records_prog(beam, row, ctx.rhoT[:, 1],
                                           ctx.Wt[:, 0], **kw)
    else:
        step = parallel.sharded_row_records(mesh, **kw)
        beam = {k: v[:, mesh.block(M, "beam")] for k, v in beam.items()}
        _, rec = step(beam, row, ctx.rhoT[:, 1], ctx.Wt[:, 0])
    return {k: v.clone() for k, v in rec.items()}


def _ranks(rank, store, out, J):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=WORLD, rank=rank)
    mesh = parallel.make_mesh(1, 4)
    ins = _solver(J)
    r = spectrum.sharded_search_spectrum(ins, ins._context(), 1, mesh,
                                         zipup_rsvd=False, **SPEC)
    ins.set_result(r)
    ins.decode_low_energy_states(**DECODE)
    res = dict(energy=ins.energy, states=ins.binary_states(),
               overflow=r.merge_overflow,
               records=_records(_solver(J)._context(), 64, 256, mesh=mesh))
    torch.save(res, os.path.join(out, f"r{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_spectrum")
    J = degenerate_J()
    spawn(_ranks, WORLD, (str(tmp / "store"), str(tmp), J))
    return J, [torch.load(tmp / f"r{r}.pt", weights_only=False)
               for r in range(WORLD)]


def _sorted(E, S):
    o = np.lexsort(np.column_stack([S, E]).T)
    return E[o], S[o]


def _assert_same_lists(E1, S1, E2, S2):
    assert len(E1) == len(E2)
    (E1, S1), (E2, S2) = _sorted(E1, S1), _sorted(E2, S2)
    np.testing.assert_allclose(E1, E2, rtol=0, atol=1e-9)
    assert np.array_equal(S1, S2)


def test_sharded_spectrum_matches_single_card(runs):
    J, got = runs
    ins = _solver(J)
    ins.search_low_energy_spectrum(excitations_encoding=1, path="device",
                                   auto_grow=False, zipup_rsvd=False, **SPEC)
    ins.decode_low_energy_states(**DECODE)
    assert len(ins.energy) > 2
    for g in got:
        assert g["overflow"] == 0
        _assert_same_lists(g["energy"], g["states"], ins.energy,
                           ins.binary_states())


def test_sharded_spectrum_matches_tnax_sharded(runs, monkeypatch):
    import tnax
    from tnax import parallel as jpar
    from tnax import spectrum as jspec
    monkeypatch.setenv("TNAX_ZIPUP_RSVD", "0")   # the port's zipup_rsvd
    J, got = runs
    ins = tnax.Solver(mode="Ising", Nx=3, Ny=3, Nc=2, beta=1.5, J=J)
    r = jspec.sharded_search_spectrum(ins, ins._context(), 1,
                                      jpar.make_mesh(1, 4), **SPEC)
    ins.excitations_encoding = 1
    ins.energy, ins.probability = r.energy, r.probability
    ins.degeneracy, ins.states = r.degeneracy, r.states[:, ins.order]
    ins.decode_low_energy_states(**DECODE)
    _assert_same_lists(got[0]["energy"], got[0]["states"], ins.energy,
                       ins.binary_states())


def test_sharded_records_are_replicated_and_match_unsharded(runs):
    J, got = runs
    want = _records(_solver(J)._context(), 64, 256)
    for g in got:
        for k, v in g["records"].items():
            assert torch.equal(v, got[0]["records"][k]), k
        for k in ORDER_FREE:
            assert torch.equal(g["records"][k], want[k]), k
    # the same candidates reach the merge, in another order
    rec = got[0]["records"]
    n = int(rec["n_valid"][0, 0])
    def pairs(r):
        return sorted(zip(r["src"][0, 0, :n].tolist(),
                          r["indc"][0, 0, :n].tolist()))
    assert pairs(rec) == pairs(want)
