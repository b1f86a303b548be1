"""Device-resident beam search, Gibbs sampling, and the flagship
pipelines around them, for one instance or a fleet.

Counterpart of the single-device ``topk`` path and the fused samplers of
``tnax/parallel.py``.
tnax vmaps one program over a fleet of instances; here every function
carries a written-out leading instance axis B, and the single search is
the fleet of one. One beam step per lattice site and per instance, all
instances in the same launches: conditional marginals (kernel K3 in the
epilogue), each instance's relative cutoff, the top-(C+1) candidates, the
merge of candidates that share a boundary-index vector (kernel K2 groups
them), the top-M groups with exact int64 degeneracy sums, and the
left-environment update. ``lax.scan`` over sites and rows becomes Python
loops; nothing in the per-site loop reads a device value on the host.

Sampling (:func:`flagship_sample`, :func:`multi_flagship_sample`) shares
the pipeline's first three stages with the search and then draws M
walkers per instance site by site (kernel K4 for the draw). tnax draws
with ``jax.random`` inside its scan; here each instance's uniforms of the
pass are drawn up front, or injected by the caller.

Energies: tnax accumulates the beam energies in the compute dtype (f32 on
the TPU, which lacks f64). Here the raw energy tables and the beam
energies are float64 in both compute dtypes, so a float32 search returns
the exact energy of its state; in float64 nothing differs from tnax.

Ties: ``lax.top_k`` puts the lower index first among equal values, and
degenerate ground states make equal log-probabilities common, so every
selection here is a stable descending sort (tnax's own ``select="sort"``
is bit-identical to its ``topk``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import engine
from . import precondition as pre
from .kernels.marginal import boltzmann_columns
from .kernels.merge import merge_segments, segment_stats_plain
from .kernels.sample import sample_site

NEG = -1e30  # effectively -inf log2 probability


# ---------------------------------------------------------------------------
# merge by boundary-index vector
# ---------------------------------------------------------------------------

def _top_k(x, k):
    """``lax.top_k`` along the last dim with its tie order: the k largest,
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pack_keys(vind, bits):
    """Pack (..., C) small-int rows into int32 grouping keys, 32 // bits
    columns per key, wrapping into the sign bit exactly as int32 shifts
    do in tnax."""
    C = vind.shape[-1]
    per = max(1, 32 // bits)
    keys = []
    for lo in range(0, C, per):
        cols = vind[..., lo:lo + per].long()
        k = torch.zeros(vind.shape[:-1], dtype=torch.int64,
                        device=vind.device)
        for c in range(cols.shape[-1]):
            k = ((k << bits) | cols[..., c]) & 0xFFFFFFFF
        keys.append(((k ^ 0x80000000) - 0x80000000).to(torch.int32))
    return keys


def _lexsort(keys):
    """``jnp.lexsort(tuple(reversed(keys)))`` along the last dim: keys[0]
    is the primary key; successive stable sorts from the least
    significant key up."""
    perm = torch.sort(keys[-1], dim=-1, stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm.gather(-1, torch.sort(k.gather(-1, perm), dim=-1,
                                          stable=True).indices)
    return perm


def merge_candidates(vind, Eng, prob, valid, min_dEng, bits, M, deg,
                     key1=None, key_bits=None):
    """Merge each instance's C expanded candidates by ``vind`` and keep
    its top-M groups.

    The minimum-energy member represents each group; degeneracies of the
    members within ``min_dEng`` of the minimum are summed, their
    log2-probabilities averaged. Invalid candidates never join a slot.
    Inputs carry the instance axis: vind (B, C, Nx+1), Eng/prob/valid/deg
    (B, C). ``key1`` (B, C) int32, if given, is an injective single-key
    encoding of (vind row, validity); its grouping and segment statistics
    are kernel K2 on CUDA, which sorts ``key_bits`` bits of it when given
    (every key in [0, 2**key_bits)). Without it the rows are lexsorted
    (plain torch).

    Returns (slot (B, C), rep (B, M), prob_out, Eng_out, out_valid, disc
    (B,), deg_out (B, M) int64).
    """
    if key1 is not None:
        perm, seg, Emin, first_min, gprob, deg_seg = merge_segments(
            key1, Eng, prob, valid, deg, min_dEng, key_bits)
    else:
        vcol = torch.where(valid, 0, 1).to(vind.dtype)[..., None]
        perm = _lexsort(pack_keys(torch.cat([vind, vcol], dim=2), bits))
        vs, vls = engine._take(vind, perm), valid.gather(1, perm)
        neq = (vs[:, 1:] != vs[:, :-1]).any(dim=2) \
            | (vls[:, 1:] != vls[:, :-1])
        seg, Emin, first_min, gprob, deg_seg = segment_stats_plain(
            perm, neq, Eng, prob, valid, deg, min_dEng)
    return select_groups(perm, seg, Emin, first_min, gprob, deg_seg, valid,
                         M)


def select_groups(perm, seg, Emin, first_min, gprob, deg_seg, valid, M):
    """Each instance's top-M groups of a merge and the slot of every
    candidate, from the grouping (perm, seg) and segment statistics
    (B, C) of ``kernels.merge.merge_segments``. Returns what
    :func:`merge_candidates` returns."""
    B, C = perm.shape
    dev = perm.device
    k = min(M + 1, C)
    gvals, gidx = _top_k(gprob, k)
    disc = gvals[:, M] if k > M else torch.full((B,), NEG, dtype=gvals.dtype,
                                                device=dev)
    gvals, gidx = gvals[:, :M], gidx[:, :M]
    out_valid = gvals > NEG / 2
    rep = perm.gather(1, torch.clamp(first_min, 0, C - 1).gather(1, gidx))
    slots = torch.arange(gidx.shape[1], device=dev).expand(B, -1)
    slot_of_seg = torch.full((B, C), -1, dtype=torch.int64,
                             device=dev).scatter(1, gidx, slots)
    slot_sorted = torch.where(valid.gather(1, perm),
                              slot_of_seg.gather(1, seg), -1)
    slot = torch.empty_like(slot_sorted).scatter(1, perm, slot_sorted)
    Eng_out = torch.where(out_valid, Emin.gather(1, gidx), 0.0)
    prob_out = torch.where(out_valid, gvals, NEG)
    deg_out = torch.where(out_valid, deg_seg.gather(1, gidx), 0)
    return slot, rep, prob_out, Eng_out, out_valid, disc, deg_out


# ---------------------------------------------------------------------------
# beam step over one lattice row
# ---------------------------------------------------------------------------

def row_step(beam, row, *, M, Nx, bits, min_dEng, log2_cutoff, cand=None):
    """Process one full lattice row of the beam search of B instances on
    the device.

    beam: dict of RL (B, M, D), vind (B, M, Nx+1) int32, states (B, M, L)
      int32, Eng (B, M) float64, prob (B, M), deg (B, M) int64, valid
      (B, M) bool, aidx (B, M).
    row: dict of per-site stacks lBT (B, Nx, lh, lv, Np) (the
      log-Boltzmann tables with the states last,
      ``kernels.marginal.boltzmann_columns``), drindex (B, Nx, Np) int64,
      AT (B, Nx, D, lv, D), RRs (B, Nx, M, D, lh), Es (B, Nx, Np), Esl
      (B, Nx, Np, lh), Esu (B, Nx, Np, lv) raw float64 energies, dmap/rmap
      (B, Nx, Np), nvalid (B, Nx) int64 on the device, and the host list
      cols (Nx,).

    Per site and per instance: relative cutoff -> merge by ``vind`` over
    the top-``cand`` candidates -> top-M groups. ``cand=None`` is the full
    M*Np expansion. Every instance has its own cutoff, counts and
    diagnostics. Returns (beam', aux) with aux = dict(mq, mqc, pd, ovf,
    cmax) of (B,) device tensors (no host sync).
    """
    B, Np = row["lBT"].shape[0], row["lBT"].shape[-1]
    C = min(cand if cand is not None else M * Np, M * Np)
    kb = (M - 1).bit_length() + 2 * bits + 1
    RL, vind, states, Eng, prob, deg, valid, aidx = (
        beam[k] for k in ("RL", "vind", "states", "Eng", "prob", "deg",
                          "valid", "aidx"))
    dev = RL.device
    take = engine._take
    mqs, mqcs, pds, ovfs, cnts = [], [], [], [], []
    for nx in range(Nx):
        AT = row["AT"][:, nx]
        Es_t, Esl_t, Esu_t = (row[k][:, nx] for k in ("Es", "Esl", "Esu"))
        dmap, rmap = row["dmap"][:, nx].long(), row["rmap"][:, nx].long()
        RRsel = take(row["RRs"][:, nx], aidx)
        lidx = vind[:, :, nx].long()
        uidx = vind[:, :, nx + 1].long()
        # Einc[b, m, p] = Eng[m] + Es[p] + Esl[p, lidx_m] + Esu[p, uidx_m];
        # the picks are exact gathers, in tnax's addition order
        Einc = ((Eng[:, :, None] + Es_t[:, None, :])
                + take(Esl_t.transpose(1, 2), lidx)) \
            + take(Esu_t.transpose(1, 2), uidx)
        # the epilogue (K3) also takes the row's reductions: pmax, and the
        # negativeness of live (mq) and of core branches (mqc)
        probf, _, pmax, mq, mqc = engine.marginal_probf(
            row["lBT"][:, nx], row["drindex"][:, nx], AT, RL, RRsel, lidx,
            uidx, row["nvalid"][:, nx], prob, valid, log2_cutoff)
        probf = probf.reshape(B, M * Np)
        mqs.append(mq)
        mqcs.append(mqc)
        pmax = pmax[:, None]
        cutoff = pmax + log2_cutoff
        flag = (probf > cutoff) & (probf > NEG / 2)
        count = flag.sum(dim=1)
        # prob-ordered top-C candidates (+1 to see the cap's first casualty)
        k = min(C + 1, M * Np)
        vals, idx = _top_k(probf, k)
        neg = torch.full((B,), NEG, dtype=vals.dtype, device=dev)
        disc_cap = neg
        if C < M * Np:
            disc_cap = torch.where(count > C, vals[:, min(C, k - 1)], neg)
        at = torch.clamp(count, 0, k - 1)[:, None]
        disc_cut = torch.where(count < M * Np, vals.gather(1, at)[:, 0], neg)
        disc_cap = torch.maximum(disc_cap, disc_cut)
        vals_c, idx_c = vals[:, :C], idx[:, :C]
        src = idx_c // Np
        indc = idx_c % Np
        live = vals_c > NEG / 2
        # the best branch always survives, even below the cutoff
        cvalid = (valid.gather(1, src) & (vals_c > cutoff) & live) \
            | ((vals_c == pmax) & live)

        E_cand = Einc.reshape(B, M * Np).gather(1, idx_c)
        d_c, r_c = dmap.gather(1, indc), rmap.gather(1, indc)
        vind_c = take(vind, src)
        vind_c[:, :, nx] = d_c.to(vind.dtype)
        vind_c[:, :, nx + 1] = r_c.to(vind.dtype)

        key1 = None
        if kb <= 31:
            # candidates share a vind row iff their parents' groups over
            # the other columns and their (dmap, rmap) coincide; parents
            # are vind-unique, so one lexsort of M rows gives the groups
            vind_p = vind.clone()
            vind_p[:, :, nx] = 0
            vind_p[:, :, nx + 1] = 0
            perm_p = _lexsort(pack_keys(vind_p, bits))
            vp = take(vind_p, perm_p)
            seg_p = torch.cat([
                torch.zeros((B, 1), dtype=torch.int64, device=dev),
                torch.cumsum((vp[:, 1:] != vp[:, :-1]).any(dim=2), 1)],
                dim=1)
            gid = torch.empty_like(seg_p).scatter(1, perm_p, seg_p)
            key1 = ((gid.gather(1, src) << (2 * bits + 1))
                    | (d_c << (bits + 1)) | (r_c << 1)
                    | (1 - cvalid.long())).to(torch.int32)
        slot, rep, prob, Eng, valid, disc_m, deg = merge_candidates(
            vind_c, E_cand, vals_c, cvalid, min_dEng, bits, M,
            deg.gather(1, src), key1=key1, key_bits=kb)
        bsrc = src.gather(1, rep)
        vind = take(vind_c, rep)
        states = take(states, bsrc)
        states[:, :, row["cols"][nx]] = indc.gather(1, rep).to(states.dtype)
        aidx = aidx.gather(1, bsrc)
        RL = engine.rl_update(take(RL, bsrc), AT, vind[:, :, nx])
        pds.append(torch.maximum(disc_cap, disc_m))
        ovfs.append(count > C)
        cnts.append(count)
    vind = torch.cat([torch.zeros_like(vind[:, :, :1]), vind[:, :, :-1]],
                     dim=2)
    out = dict(RL=RL, vind=vind, states=states, Eng=Eng, prob=prob, deg=deg,
               valid=valid, aidx=aidx)
    aux = dict(mq=torch.stack(mqs, 1).amin(1),
               mqc=torch.stack(mqcs, 1).amin(1),
               pd=torch.stack(pds, 1).amax(1),
               ovf=torch.stack(ovfs, 1).sum(1),
               cmax=torch.stack(cnts, 1).amax(1))
    return out, aux


_AUX_REDUCE = dict(mq=torch.amin, mqc=torch.amin, pd=torch.amax,
                   ovf=torch.sum, cmax=torch.amax)


def full_search_scan(beam0, grid_in, rhoT, Wt, *, M, Nx, bits, min_dEng,
                     log2_cutoff, cand=None):
    """The whole ground-state search of B instances: per lattice row, the
    right environments of every branch, then :func:`row_step`'s site loop.

    grid_in: dict of (B, Ny, ...) stacks lBT, drindex, Es, Esl, Esu,
    dmap, rmap, nvalid (B, Ny, Nx) on the device (as :func:`row_step`
    takes them), and the host list cols (Ny, Nx). rhoT (B, Ny+1, Nx, D, lv, D), Wt (B, Ny, Nx, lh, lv, lh, lv).
    Returns (beam, aux) with aux reduced over rows, per instance.
    """
    B, D = rhoT.shape[0], rhoT.shape[3]
    Ny = Wt.shape[1]
    beam = dict(beam0)
    auxs = []
    for ny in range(Ny):
        beam["aidx"] = torch.arange(M, device=rhoT.device).expand(B, M)
        beam["RL"] = _unit_rows(B, M, D, rhoT)
        RRs = engine.row_right_envs(rhoT[:, ny + 1], Wt[:, ny],
                                    beam["vind"][:, :, 1:])
        row = {k: v[ny] if k == "cols" else v[:, ny]
               for k, v in grid_in.items()}
        row.update(AT=rhoT[:, ny + 1], RRs=RRs)
        beam, aux = row_step(beam, row, M=M, Nx=Nx, bits=bits,
                             min_dEng=min_dEng, log2_cutoff=log2_cutoff,
                             cand=cand)
        auxs.append(aux)
    aux = {k: fn(torch.stack([a[k] for a in auxs], 1), 1)
           for k, fn in _AUX_REDUCE.items()}
    return beam, aux


def _unit_rows(B, M, D, like):
    RL = torch.zeros((B, M, D), dtype=like.dtype, device=like.device)
    RL[:, :, 0] = 1.0
    return RL


def _initial_beam(B, M, D, Nx, Ny, dtype, device):
    prob = torch.full((B, M), NEG, dtype=dtype, device=device)
    prob[:, 0] = 0.0
    valid = torch.zeros((B, M), dtype=torch.bool, device=device)
    valid[:, 0] = True
    return dict(
        RL=_unit_rows(B, M, D, prob),
        vind=torch.zeros((B, M, Nx + 1), dtype=torch.int32, device=device),
        states=torch.zeros((B, M, Nx * Ny), dtype=torch.int32,
                           device=device),
        Eng=torch.zeros((B, M), dtype=torch.float64, device=device),
        prob=prob,
        deg=torch.ones((B, M), dtype=torch.int64, device=device),
        valid=valid,
        aidx=torch.arange(M, device=device).expand(B, M),
    )


class _StageClock:
    """Seconds per pipeline stage, each ended by a device synchronize;
    inert when no dict is given."""

    def __init__(self, out, device):
        self.out, self.device = out, device
        self.t = time.perf_counter() if out is not None else None

    def lap(self, name):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now


def _fleet_tables(solvers, pre_steps, max_scale):
    """Check that ``solvers`` form a fleet and stack what the pipeline
    takes into device tensors with a leading instance axis.

    The instances must share (Ny, Nx, Np, lh, lv), beta, device and dtype
    (ValueError otherwise). Returns a dict of the dims, the device and
    dtype, the stacked tables of the ladder and the PEPS rows, the
    ladder's betas and max_scale, nvalid (B, Ny, Nx) and the host list
    cols (Ny, Nx) of snake-order columns.
    """
    if not solvers:
        raise ValueError("a fleet needs at least one solver")
    ins0 = solvers[0]
    grids = [engine.pad_grid(ins.problem) for ins in solvers]
    shape = lambda g: (g.Ny, g.Nx, g.Np, g.lh, g.lv)   # noqa: E731
    for ins, g in zip(solvers, grids):
        if shape(g) != shape(grids[0]):
            raise ValueError(f"fleet instances must share (Ny, Nx, Np, lh, "
                             f"lv): {shape(g)} != {shape(grids[0])}")
        if ins.beta != ins0.beta:
            raise ValueError(f"fleet instances share one beta: {ins.beta} "
                             f"!= {ins0.beta}")
        if (ins.device, ins.dtype) != (ins0.device, ins0.dtype):
            raise ValueError(f"fleet instances share one device and dtype: "
                             f"{ins.device} {ins.dtype} != {ins0.device} "
                             f"{ins0.dtype}")
    dtype, dev = ins0.dtype, ins0.device
    Ny, Nx, _, lh, lv = shape(grids[0])
    B = len(solvers)

    def fleet(arrays, dt=dtype):
        """Stack one host array per instance into a device tensor."""
        return torch.as_tensor(np.stack(arrays), device=dev).to(dt)

    return dict(
        B=B, Ny=Ny, Nx=Nx, lh=lh, lv=lv, dtype=dtype, device=dev,
        Es=fleet([g.Es for g in grids]), Esl=fleet([g.Esl for g in grids]),
        Esu=fleet([g.Esu for g in grids]),
        dmap=fleet([g.dmap for g in grids], torch.int32),
        rmap=fleet([g.rmap for g in grids], torch.int32),
        X0={k: fleet([v] * B)
            for k, v in engine.identity_gauges(grids[0]).items()},
        ndall=fleet([ins.problem.ld[: Ny - 1] for ins in solvers],
                    torch.int32),
        nvalid=fleet([g.nstates for g in grids], torch.int64),
        betas=[ins0.beta * 2.0 ** (nn - pre_steps)
               for nn in range(pre_steps)],
        max_scale=float(2.0 ** np.floor(np.log2(np.sqrt(max_scale)))),
        beta=float(ins0.beta),
        cols=(np.arange(Ny)[:, None] * Nx
              + np.arange(Nx)[None, :]).tolist())


def _boundary_stages(f, clock, *, Dmax, tolS, tolV, max_sweeps, pre_Dmax,
                     pre_sweeps, rsvd, omega):
    """Stages 1-3 of the flagship pipelines of B instances (the fleet
    ``f`` of :func:`_fleet_tables`): the balancing beta ladder (gauges),
    the gauged Boltzmann and traced row tensors at the target beta, and
    the top boundary-MPS stacks. The ladder always zips up with the
    sketch, as tnax's flagship does (its ladder reads the ambient
    default); ``rsvd`` sets the main stack. Returns (lB, drindex, Wt,
    rhoT)."""
    lh, lv = f["lh"], f["lv"]
    X, _ = pre._ladder_program(f["Es"], f["Esl"], f["Esu"], f["dmap"],
                               f["rmap"], f["X0"], f["betas"], f["ndall"],
                               f["max_scale"], Dmax=pre_Dmax, tolS=tolS,
                               tolV=tolV, max_sweeps=pre_sweeps, lh=lh,
                               lv=lv, omega=omega)
    clock.lap("ladder")
    lB, Wt = engine.peps_rows(f["Es"], f["Esl"], f["Esu"], f["dmap"],
                              f["rmap"], X["Xl"], X["Xr"], X["Xu"], X["Xd"],
                              f["beta"], lh=lh, lv=lv)
    drindex = f["dmap"].long() * lh + f["rmap"].long()
    clock.lap("peps")
    rhoT = engine.build_rhoT(Wt, Dmax=Dmax, tolS=tolS, tolV=tolV,
                             max_sweeps=max_sweeps, rsvd=rsvd,
                             omega=omega)[0]
    clock.lap("boundary")
    return lB, drindex, Wt, rhoT


def _flagship_body(f, EsR, EslR, EsuR, *, M, bits, min_dEng, log2_cutoff,
                   cand, Dmax, tolS, tolV, max_sweeps, pre_Dmax, pre_sweeps,
                   rsvd=True, omega=None, stage_times=None):
    """The flagship search pipeline of B instances at once: the stages of
    :func:`_boundary_stages`, then the full beam search. Every tensor
    carries the leading instance axis (tnax vmaps this body over the
    fleet, parallel.py:1072-1076); one instance is B = 1. EsR, EslR, EsuR
    are the raw float64 energy tables (B, Ny, Nx, ...). ``stage_times``,
    if a dict, receives the seconds of the four stages (ladder, peps,
    boundary, search), each ended by a synchronize. Returns (beam, aux).
    """
    clock = _StageClock(stage_times, f["device"])
    lB, drindex, Wt, rhoT = _boundary_stages(
        f, clock, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps, rsvd=rsvd, omega=omega)
    # the Boltzmann tables with the states last, made once per search: a
    # branch's column is then one contiguous run for the epilogue (K3)
    grid_in = dict(lBT=boltzmann_columns(lB), drindex=drindex, Es=EsR,
                   Esl=EslR, Esu=EsuR, dmap=f["dmap"], rmap=f["rmap"],
                   nvalid=f["nvalid"], cols=f["cols"])
    beam0 = _initial_beam(f["B"], M, Dmax, f["Nx"], f["Ny"], f["dtype"],
                          f["device"])
    beam, aux = full_search_scan(beam0, grid_in, rhoT, Wt, M=M, Nx=f["Nx"],
                                 bits=bits, min_dEng=min_dEng,
                                 log2_cutoff=log2_cutoff, cand=cand)
    clock.lap("search")
    return beam, aux


def multi_flagship_search_gs(solvers, M=2 ** 10, relative_P_cutoff=1e-6,
                             min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                             max_sweeps=2, cand_factor=8, pre_steps=1,
                             pre_Dmax=8, pre_sweeps=20, max_scale=1024,
                             zipup_rsvd=True, omega=None, stage_times=None):
    """Fleet GS search: the flagship pipeline (balancing ladder, boundary
    build, beam search) run once over a batch of same-shape Solver
    instances, every stage with a leading instance axis (tnax's
    ``multi_flagship_search_gs``, topk selection). Each instance's result
    is the one :func:`flagship_search_gs` gives it alone.

    The instances must share (Ny, Nx, Np, lh, lv), beta, device and dtype
    (ValueError otherwise). ``cand_factor`` sizes each instance's merge
    candidate set at ``cand_factor*M`` (None = the full M*Np expansion,
    the uncapped exact merge; kernel K2 takes any cap). ``omega`` is the
    zip-up sketch, shared
    by the fleet (see ``bmps.zipup_apply``): a callable
    ``(L, n, k) -> tensor`` or None for the seeded default.
    ``stage_times``, if a dict, receives the seconds of the four stages
    of the whole batch.

    Returns a list with one dict(energy, states, prob, degeneracy,
    negative_probability, negative_probability_core,
    discarded_probability, merge_overflow, count_max) per instance, as
    tnax does; ``energy`` is the beam's float64 energy.
    """
    f = _fleet_tables(solvers, pre_steps, max_scale)
    bits = max(1, int(np.ceil(np.log2(max(f["lh"], f["lv"])))))
    log2_cutoff = float(np.log2(relative_P_cutoff)) \
        if relative_P_cutoff > 0 else NEG
    cand = None if cand_factor is None else int(cand_factor) * M
    rows = [_padded_energy_rows_problem(ins.problem) for ins in solvers]
    EsR, EslR, EsuR = (torch.as_tensor(np.stack([r[i] for r in rows]),
                                       device=f["device"])
                       for i in range(3))
    beam, aux = _flagship_body(
        f, EsR, EslR, EsuR, M=M, bits=bits, min_dEng=min_dEng,
        log2_cutoff=log2_cutoff, cand=cand, Dmax=Dmax, tolS=tolS, tolV=tolV,
        max_sweeps=max_sweeps, pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps,
        rsvd=zipup_rsvd, omega=omega, stage_times=stage_times)
    # one pull of the final beams and diagnostics
    host = {k: beam[k].cpu().numpy()
            for k in ("valid", "Eng", "prob", "deg", "states")}
    aux = {k: v.cpu().numpy() for k, v in aux.items()}
    results = []
    for b in range(len(solvers)):
        valid = host["valid"][b]
        Eng = host["Eng"][b].astype(np.float64)
        best = int(np.argmin(np.where(valid, Eng, np.inf)))
        results.append(dict(
            energy=float(Eng[best]), states=host["states"][b][best],
            prob=float(host["prob"][b][best]),
            degeneracy=int(host["deg"][b][best]),
            negative_probability=min(0.0, float(aux["mq"][b])),
            negative_probability_core=min(0.0, float(aux["mqc"][b])),
            discarded_probability=float(aux["pd"][b]),
            merge_overflow=int(aux["ovf"][b]),
            count_max=int(aux["cmax"][b])))
    return results


def flagship_search_gs(ins, M=2 ** 10, relative_P_cutoff=1e-6,
                       min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                       max_sweeps=2, cand_factor=8, pre_steps=1, pre_Dmax=8,
                       pre_sweeps=20, max_scale=1024, zipup_rsvd=True,
                       omega=None, stage_times=None):
    """Flagship GS search on ``ins.device`` in ``ins.dtype``: balancing
    preconditioner ladder, boundary build and beam search (tnax's
    ``flagship_search_gs``, topk selection). It is the fleet of one:
    :func:`multi_flagship_search_gs` with B = 1, whose arguments and
    result keys it shares.
    """
    return multi_flagship_search_gs(
        [ins], M=M, relative_P_cutoff=relative_P_cutoff, min_dEng=min_dEng,
        Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        cand_factor=cand_factor, pre_steps=pre_steps, pre_Dmax=pre_Dmax,
        pre_sweeps=pre_sweeps, max_scale=max_scale, zipup_rsvd=zipup_rsvd,
        omega=omega, stage_times=stage_times)[0]


# ---------------------------------------------------------------------------
# Gibbs sampling
# ---------------------------------------------------------------------------

def sample_rows(beam, row, u_row, *, M, Nx):
    """One lattice row of Gibbs sampling for the M walkers of each of B
    instances (tnax parallel.py:1283-1313, with the instance axis): per
    site the two GEMMs of the conditional marginals, then kernel K4
    (``kernels.sample.sample_site``), which draws one state per walker,
    writes it and its boundary indices into the walker, updates the left
    environments and folds the row's minimum of mPn; nothing else runs per
    site. Walkers never reorder, so the row-start right environments apply
    directly.

    beam: dict of RL (B, M, D), vind (B, M, Nx+1) int32, states (B, M, L)
      int32.
    row: dict of per-site stacks lBT (B, Nx, lh, lv, Np) (the
      log-Boltzmann tables with the states last,
      ``kernels.marginal.boltzmann_columns``), drindex (B, Nx, Np) int64,
      AT (B, Nx, D, lv, D), RRs (B, Nx, M, D, lh), dmap/rmap (B, Nx, Np)
      int32, nvalid (B, Nx) int64 on the device, and the host list cols
      (Nx,).
    u_row: (B, Nx, M) uniforms in [0, 1) in the compute dtype.

    Returns (beam', mq (B,)): mq is each instance's least mPn over the
    row's sites and walkers. Nothing is read back to the host, and the
    input beam is left as it was.
    """
    RL = beam["RL"]
    vind, states = beam["vind"].clone(), beam["states"].clone()
    mq = torch.full((RL.shape[0],), float("inf"), dtype=RL.dtype,
                    device=RL.device)
    for nx in range(Nx):
        AT = row["AT"][:, nx]
        T2 = engine._marginal_T2(AT, RL, row["RRs"][:, nx])
        RL, _ = sample_site(
            T2, row["lBT"][:, nx], row["drindex"][:, nx], row["dmap"][:, nx],
            row["rmap"][:, nx], row["nvalid"][:, nx], u_row[:, nx], AT, RL,
            vind, states, nx, row["cols"][nx], mq)
    vind = torch.cat([torch.zeros_like(vind[:, :, :1]), vind[:, :, :-1]],
                     dim=2)
    return dict(RL=RL, vind=vind, states=states), mq


def full_sample_scan(beam0, grid_in, rhoT, Wt, u, *, M, Nx):
    """The whole Gibbs sampling pass of B instances (tnax
    parallel.py:1352-1371): per lattice row, unit left environments, the
    right environments of every walker, then :func:`sample_rows`.

    grid_in: dict of (B, Ny, ...) stacks lBT, drindex, dmap, rmap, nvalid
    (B, Ny, Nx) on the device (as :func:`sample_rows` takes them), and the
    host list cols (Ny, Nx). rhoT (B, Ny+1, Nx, D, lv, D), Wt
    (B, Ny, Nx, lh, lv, lh, lv), u (B, Ny, Nx, M). Returns (beam, mq (B,)).
    """
    B, D = rhoT.shape[0], rhoT.shape[3]
    Ny = Wt.shape[1]
    beam, mqs = dict(beam0), []
    for ny in range(Ny):
        beam["RL"] = _unit_rows(B, M, D, rhoT)
        RRs = engine.row_right_envs(rhoT[:, ny + 1], Wt[:, ny],
                                    beam["vind"][:, :, 1:])
        row = {k: v[ny] if k == "cols" else v[:, ny]
               for k, v in grid_in.items()}
        row.update(AT=rhoT[:, ny + 1], RRs=RRs)
        beam, mq = sample_rows(beam, row, u[:, ny], M=M, Nx=Nx)
        mqs.append(mq)
    return beam, torch.stack(mqs, 1).amin(1)


def _flagship_sample_body(f, u, *, M, Dmax, tolS, tolV, max_sweeps,
                          pre_Dmax, pre_sweeps, rsvd=True, omega=None,
                          stage_times=None):
    """The Gibbs sampling pipeline of B instances at once (tnax
    parallel.py:1438-1467, vmapped there): the stages of
    :func:`_boundary_stages`, then the M-walker sampling pass on the
    uniforms u (B, Ny, Nx, M). ``stage_times``, if a dict, receives the
    seconds of the four stages (ladder, peps, boundary, sample). Returns
    (states (B, M, Ny*Nx), mq (B,))."""
    clock = _StageClock(stage_times, f["device"])
    lB, drindex, Wt, rhoT = _boundary_stages(
        f, clock, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps, rsvd=rsvd, omega=omega)
    B, Ny, Nx = f["B"], f["Ny"], f["Nx"]
    # the Boltzmann tables with the states last, made once per pass, as
    # for the search: a walker's column is one contiguous run for K4
    grid_in = dict(lBT=boltzmann_columns(lB), drindex=drindex,
                   dmap=f["dmap"], rmap=f["rmap"], nvalid=f["nvalid"],
                   cols=f["cols"])
    dev = f["device"]
    beam0 = dict(RL=_unit_rows(B, M, Dmax, rhoT),
                 vind=torch.zeros((B, M, Nx + 1), dtype=torch.int32,
                                  device=dev),
                 states=torch.zeros((B, M, Nx * Ny), dtype=torch.int32,
                                    device=dev))
    beam, mq = full_sample_scan(beam0, grid_in, rhoT, Wt, u, M=M, Nx=Nx)
    clock.lap("sample")
    return beam["states"], mq


def instance_uniforms(seed, b, shape, dtype, device):
    """The uniforms of instance b of a fleet sampled with ``seed``: one
    draw of ``shape`` in [0, 1) from a generator on ``device`` seeded from
    (seed, b) alone, so an instance's samples do not depend on the fleet
    it runs in."""
    state = np.random.SeedSequence([seed, b]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) >> 1)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def multi_flagship_sample(solvers, M=2 ** 10, Dmax=32, tolS=1e-15,
                          tolV=1e-10, max_sweeps=20, seed=0, pre_steps=1,
                          pre_Dmax=8, pre_sweeps=20, max_scale=1024,
                          zipup_rsvd=True, omega=None, uniforms=None,
                          stage_times=None):
    """Fleet Gibbs sampling: the sampling pipeline (balancing ladder,
    boundary build, M-walker sampling pass) run once over a batch of
    same-shape Solver instances, every stage with a leading instance axis
    (tnax's ``multi_flagship_sample`` without a mesh; the reference's
    production pattern of e02).

    The instances must share (Ny, Nx, Np, lh, lv), beta, device and dtype
    (ValueError otherwise). Random numbers: with ``uniforms=None``
    instance b draws its (Ny, Nx, M) uniforms of the pass at the start
    from its own generator on the device, seeded from (seed, b) alone
    (:func:`instance_uniforms`); ``uniforms`` (B, Ny, Nx, M) in [0, 1)
    injects them instead, walker m at site (ny, nx) using
    ``uniforms[b, ny, nx, m]``. ``omega`` is the zip-up sketch (see
    :func:`multi_flagship_search_gs`). ``stage_times``, if a dict,
    receives the seconds of the four stages (ladder, peps, boundary,
    sample) of the whole batch.

    Returns a list with one dict(states (M, Ny*Nx) int32 block states,
    energy (M,) exact float64 energies replayed on the host,
    negative_probability) per instance, as tnax does.
    """
    f = _fleet_tables(solvers, pre_steps, max_scale)
    dtype, dev = f["dtype"], f["device"]
    shape = (f["B"], f["Ny"], f["Nx"], M)
    if uniforms is None:
        u = torch.stack([instance_uniforms(seed, b, shape[1:], dtype, dev)
                         for b in range(f["B"])])
    else:
        u = torch.as_tensor(uniforms, device=dev).to(dtype)
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms must have shape {shape} "
                             f"(B, Ny, Nx, M), got {tuple(u.shape)}")
    states, mq = _flagship_sample_body(
        f, u, M=M, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps, rsvd=zipup_rsvd,
        omega=omega, stage_times=stage_times)
    states, mq = states.cpu().numpy(), mq.cpu().numpy()   # one pull
    return [dict(states=states[b],
                 energy=exact_energies_problem(ins.problem, states[b]),
                 negative_probability=min(0.0, float(mq[b])))
            for b, ins in enumerate(solvers)]


def flagship_sample(ins, M=2 ** 10, Dmax=32, tolS=1e-15, tolV=1e-10,
                    max_sweeps=20, seed=0, pre_steps=1, pre_Dmax=8,
                    pre_sweeps=20, max_scale=1024, zipup_rsvd=True,
                    omega=None, uniforms=None, stage_times=None):
    """Gibbs sampling on ``ins.device`` in ``ins.dtype``: balancing
    preconditioner ladder, boundary build and the M-walker sampling pass
    (tnax's ``flagship_sample``). It is the fleet of one:
    :func:`multi_flagship_sample` with B = 1, so ``seed`` gives the
    uniforms of instance 0 of a fleet, and ``uniforms`` (Ny, Nx, M)
    injects them. Returns dict(states, energy, negative_probability).
    """
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms)[None]
    return multi_flagship_sample(
        [ins], M=M, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        seed=seed, pre_steps=pre_steps, pre_Dmax=pre_Dmax,
        pre_sweeps=pre_sweeps, max_scale=max_scale, zipup_rsvd=zipup_rsvd,
        omega=omega, uniforms=uniforms, stage_times=stage_times)[0]


def _padded_energy_rows_problem(problem):
    """Raw (unshifted) energy tables padded to grid shapes (NumPy),
    cached on the problem."""
    cached = getattr(problem, "_energy_rows_np", None)
    if cached is not None:
        return cached
    g = engine.pad_grid(problem)
    Ny, Nx, Np, lh, lv = g.Ny, g.Nx, g.Np, g.lh, g.lv
    Es = np.zeros((Ny, Nx, Np))
    Esl = np.zeros((Ny, Nx, Np, lh))
    Esu = np.zeros((Ny, Nx, Np, lv))
    for ny in range(Ny):
        for nx in range(Nx):
            t = problem.site(ny, nx)
            n = len(t.Es)
            Es[ny, nx, :n] = t.Es
            Esl[ny, nx, :n, :t.Esl.shape[1]] = t.Esl
            Esu[ny, nx, :n, :t.Esu.shape[1]] = t.Esu
    problem._energy_rows_np = (Es, Esl, Esu)
    return problem._energy_rows_np


def exact_energies_problem(problem, states):
    """Exact float64 energies of block-state configurations (M, Ny*Nx) in
    snake order, replayed on the host from the raw energy tables
    (NumPy; tnax's ``exact_energies_problem``)."""
    g = engine.pad_grid(problem)
    states = np.asarray(states)
    Ny, Nx = g.Ny, g.Nx
    Eng = np.zeros(states.shape[0])
    for ny in range(Ny):
        for nx in range(Nx):
            s = states[:, ny * Nx + nx]
            t = problem.site(ny, nx)
            lidx = g.rmap[ny, nx - 1][states[:, ny * Nx + nx - 1]] \
                if nx > 0 else np.zeros(len(s), np.int32)
            uidx = g.dmap[ny - 1, nx][states[:, (ny - 1) * Nx + nx]] \
                if ny > 0 else np.zeros(len(s), np.int32)
            Eng += t.Es[s] + t.Esl[s, lidx] + t.Esu[s, uidx]
    return Eng
