"""Device-resident beam search and the flagship ground-state pipeline.

Counterpart of the single-device ``topk`` path of ``tnax/parallel.py``.
One beam step per lattice site: conditional marginals (kernel K3 in the
epilogue), the global relative cutoff, the top-(C+1) candidates, the
merge of candidates that share a boundary-index vector (kernel K2 groups
them), the top-M groups with exact int64 degeneracy sums, and the
left-environment update. ``lax.scan`` over sites and rows becomes Python
loops; nothing in the per-site loop reads a device value on the host.

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
from .kernels.merge import merge_segments, segment_stats_plain

NEG = -1e30  # effectively -inf log2 probability


# ---------------------------------------------------------------------------
# merge by boundary-index vector
# ---------------------------------------------------------------------------

def _top_k(x, k):
    """``lax.top_k`` with its tie order: the k largest, lower index first
    among equal values."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def pack_keys(vind, bits):
    """Pack (M, C) small-int rows into int32 grouping keys, 32 // bits
    columns per key, wrapping into the sign bit exactly as int32 shifts
    do in tnax."""
    M, C = vind.shape
    per = max(1, 32 // bits)
    keys = []
    for lo in range(0, C, per):
        cols = vind[:, lo:lo + per].long()
        k = torch.zeros((M,), dtype=torch.int64, device=vind.device)
        for c in range(cols.shape[1]):
            k = ((k << bits) | cols[:, c]) & 0xFFFFFFFF
        keys.append(((k ^ 0x80000000) - 0x80000000).to(torch.int32))
    return keys


def _lexsort(keys):
    """``jnp.lexsort(tuple(reversed(keys)))``: keys[0] is the primary key;
    successive stable sorts from the least significant key up."""
    perm = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def merge_candidates(vind, Eng, prob, valid, min_dEng, bits, M, deg,
                     key1=None):
    """Merge C expanded candidates by ``vind`` and keep the top-M groups.

    The minimum-energy member represents each group; degeneracies of the
    members within ``min_dEng`` of the minimum are summed, their
    log2-probabilities averaged. Invalid candidates never join a slot.
    ``key1`` (C,) int32, if given, is an injective single-key encoding of
    (vind row, validity); its grouping and segment statistics are kernel
    K2 on CUDA. Without it the rows are lexsorted (plain torch).

    Returns (slot (C,), rep (M,), prob_out, Eng_out, out_valid, disc,
    deg_out (M,) int64).
    """
    if key1 is not None:
        perm, seg, Emin, first_min, gprob, deg_seg = merge_segments(
            key1, Eng, prob, valid, deg, min_dEng)
    else:
        vcol = torch.where(valid, 0, 1).to(vind.dtype)[:, None]
        perm = _lexsort(pack_keys(torch.cat([vind, vcol], dim=1), bits))
        vs, vls = vind[perm], valid[perm]
        neq = (vs[1:] != vs[:-1]).any(dim=1) | (vls[1:] != vls[:-1])
        seg, Emin, first_min, gprob, deg_seg = segment_stats_plain(
            perm, neq, Eng, prob, valid, deg, min_dEng)
    return select_groups(perm, seg, Emin, first_min, gprob, deg_seg, valid,
                         M)


def select_groups(perm, seg, Emin, first_min, gprob, deg_seg, valid, M):
    """The top-M groups of a merge and the slot of every candidate, from
    the grouping (perm, seg) and segment statistics of
    ``kernels.merge.merge_segments``. Returns what
    :func:`merge_candidates` returns."""
    C = perm.shape[0]
    dev = perm.device
    k = min(M + 1, C)
    gvals, gidx = _top_k(gprob, k)
    disc = gvals[M] if k > M else torch.full((), NEG, dtype=gvals.dtype,
                                             device=dev)
    gvals, gidx = gvals[:M], gidx[:M]
    out_valid = gvals > NEG / 2
    rep = perm[torch.clamp(first_min, 0, C - 1)[gidx]]
    slot_of_seg = torch.full((C,), -1, dtype=torch.int64, device=dev)
    slot_of_seg[gidx] = torch.arange(gidx.shape[0], device=dev)
    slot_sorted = torch.where(valid[perm], slot_of_seg[seg], -1)
    slot = torch.empty_like(slot_sorted)
    slot[perm] = slot_sorted
    Eng_out = torch.where(out_valid, Emin[gidx], 0.0)
    prob_out = torch.where(out_valid, gvals, NEG)
    deg_out = torch.where(out_valid, deg_seg[gidx], 0)
    return slot, rep, prob_out, Eng_out, out_valid, disc, deg_out


# ---------------------------------------------------------------------------
# beam step over one lattice row
# ---------------------------------------------------------------------------

def row_step(beam, row, *, M, Nx, bits, min_dEng, log2_cutoff, cand=None):
    """Process one full lattice row of the beam search on the device.

    beam: dict of RL (M, D), vind (M, Nx+1) int32, states (M, L) int32,
      Eng (M,) float64, prob (M,), deg (M,) int64, valid (M,) bool,
      aidx (M,).
    row: dict of per-site stacks lB (Nx, Np, lh, lv), drindex (Nx, Np),
      AT (Nx, D, lv, D), RRs (Nx, M, D, lh), Es (Nx, Np), Esl (Nx, Np, lh),
      Esu (Nx, Np, lv) raw float64 energies, dmap/rmap (Nx, Np), and the
      host lists nvalid (Nx,) and cols (Nx,).

    Per site: relative cutoff -> merge by ``vind`` over the top-``cand``
    candidates -> top-M groups. ``cand=None`` is the full M*Np expansion.
    Returns (beam', aux) with aux = dict(mq, mqc, pd, ovf, cmax) as
    0-dim device tensors (no host sync).
    """
    Np = row["lB"].shape[1]
    C = min(cand if cand is not None else M * Np, M * Np)
    kb = (M - 1).bit_length() + 2 * bits + 1
    RL, vind, states, Eng, prob, deg, valid, aidx = (
        beam[k] for k in ("RL", "vind", "states", "Eng", "prob", "deg",
                          "valid", "aidx"))
    dev = RL.device
    mqs, mqcs, pds, ovfs, cnts = [], [], [], [], []
    for nx in range(Nx):
        AT = row["AT"][nx]
        Es_t, Esl_t, Esu_t = row["Es"][nx], row["Esl"][nx], row["Esu"][nx]
        dmap, rmap = row["dmap"][nx].long(), row["rmap"][nx].long()
        RRsel = row["RRs"][nx][aidx]
        lidx = vind[:, nx].long()
        uidx = vind[:, nx + 1].long()
        # Einc[m, p] = Eng[m] + Es[p] + Esl[p, lidx_m] + Esu[p, uidx_m];
        # the picks are exact gathers, in tnax's addition order
        Einc = ((Eng[:, None] + Es_t[None, :]) + Esl_t[:, lidx].T) \
            + Esu_t[:, uidx].T
        probf, mPn = engine.marginal_probf(
            row["lB"][nx], row["drindex"][nx], AT, RL, RRsel, lidx, uidx,
            row["nvalid"][nx], prob, valid)
        probf = probf.reshape(M * Np)
        # negativeness only from live branches, and (core) only from those
        # within the cutoff window of the best branch
        mqs.append(torch.where(valid, mPn, 0.0).min())
        bmax = torch.where(valid, prob, NEG).max()
        core = valid & (prob > bmax + log2_cutoff)
        mqcs.append(torch.where(core, mPn, 0.0).min())

        pmax = probf.max()
        cutoff = pmax + log2_cutoff
        flag = (probf > cutoff) & (probf > NEG / 2)
        count = flag.sum()
        # prob-ordered top-C candidates (+1 to see the cap's first casualty)
        k = min(C + 1, M * Np)
        vals, idx = _top_k(probf, k)
        neg = torch.full((), NEG, dtype=vals.dtype, device=dev)
        disc_cap = neg
        if C < M * Np:
            disc_cap = torch.where(count > C, vals[min(C, k - 1)], neg)
        at = torch.clamp(count, 0, k - 1).reshape(1)
        disc_cut = torch.where(count < M * Np, vals.index_select(0, at)[0],
                               neg)
        disc_cap = torch.maximum(disc_cap, disc_cut)
        vals_c, idx_c = vals[:C], idx[:C]
        src = idx_c // Np
        indc = idx_c % Np
        live = vals_c > NEG / 2
        # the best branch always survives, even below the cutoff
        cvalid = (valid[src] & (vals_c > cutoff) & live) \
            | ((vals_c == pmax) & live)

        E_cand = Einc.reshape(M * Np)[idx_c]
        vind_c = vind[src]
        vind_c[:, nx] = dmap[indc].to(vind.dtype)
        vind_c[:, nx + 1] = rmap[indc].to(vind.dtype)

        key1 = None
        if kb <= 31:
            # candidates share a vind row iff their parents' groups over
            # the other columns and their (dmap, rmap) coincide; parents
            # are vind-unique, so one lexsort of M rows gives the groups
            vind_p = vind.clone()
            vind_p[:, nx] = 0
            vind_p[:, nx + 1] = 0
            perm_p = _lexsort(pack_keys(vind_p, bits))
            vp = vind_p[perm_p]
            seg_p = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.cumsum((vp[1:] != vp[:-1]).any(dim=1),
                                            0)])
            gid = torch.empty_like(seg_p)
            gid[perm_p] = seg_p
            key1 = ((gid[src] << (2 * bits + 1)) | (dmap[indc] << (bits + 1))
                    | (rmap[indc] << 1) | (1 - cvalid.long())).to(torch.int32)
        slot, rep, prob, Eng, valid, disc_m, deg = merge_candidates(
            vind_c, E_cand, vals_c, cvalid, min_dEng, bits, M, deg[src],
            key1=key1)
        bsrc = src[rep]
        vind = vind_c[rep]
        states = states[bsrc]
        states[:, row["cols"][nx]] = indc[rep].to(states.dtype)
        aidx = aidx[bsrc]
        RL = engine.rl_update(RL[bsrc], AT, vind[:, nx])
        pds.append(torch.maximum(disc_cap, disc_m))
        ovfs.append(count > C)
        cnts.append(count)
    vind = torch.cat([torch.zeros_like(vind[:, :1]), vind[:, :-1]], dim=1)
    out = dict(RL=RL, vind=vind, states=states, Eng=Eng, prob=prob, deg=deg,
               valid=valid, aidx=aidx)
    aux = dict(mq=torch.stack(mqs).min(), mqc=torch.stack(mqcs).min(),
               pd=torch.stack(pds).max(),
               ovf=torch.stack(ovfs).sum(), cmax=torch.stack(cnts).max())
    return out, aux


def full_search_scan(beam0, grid_in, rhoT, Wt, *, M, Nx, bits, min_dEng,
                     log2_cutoff, cand=None):
    """The whole ground-state search: per lattice row, the right
    environments of every branch, then :func:`row_step`'s site loop.

    grid_in: dict of (Ny, ...) stacks lB, drindex, Es, Esl, Esu, dmap,
    rmap, and host arrays nvalid (Ny, Nx), cols (Ny, Nx).
    rhoT (Ny+1, Nx, D, lv, D), Wt (Ny, Nx, lh, lv, lh, lv).
    Returns (beam, aux) with aux reduced over rows.
    """
    D = rhoT.shape[2]
    Ny = Wt.shape[0]
    beam = dict(beam0)
    auxs = []
    for ny in range(Ny):
        beam["aidx"] = torch.arange(M, device=rhoT.device)
        beam["RL"] = _unit_rows(M, D, rhoT)
        RRs = engine.row_right_envs(rhoT[ny + 1], Wt[ny], beam["vind"][:, 1:])
        row = {k: v[ny] for k, v in grid_in.items()}
        row.update(AT=rhoT[ny + 1], RRs=RRs)
        beam, aux = row_step(beam, row, M=M, Nx=Nx, bits=bits,
                             min_dEng=min_dEng, log2_cutoff=log2_cutoff,
                             cand=cand)
        auxs.append(aux)

    def red(key, fn):
        return fn(torch.stack([a[key] for a in auxs]))

    aux = dict(mq=red("mq", torch.min), mqc=red("mqc", torch.min),
               pd=red("pd", torch.max), ovf=red("ovf", torch.sum),
               cmax=red("cmax", torch.max))
    return beam, aux


def _unit_rows(M, D, like):
    RL = torch.zeros((M, D), dtype=like.dtype, device=like.device)
    RL[:, 0] = 1.0
    return RL


def _initial_beam(M, D, Nx, Ny, dtype, device):
    prob = torch.full((M,), NEG, dtype=dtype, device=device)
    prob[0] = 0.0
    valid = torch.zeros((M,), dtype=torch.bool, device=device)
    valid[0] = True
    return dict(
        RL=_unit_rows(M, D, prob),
        vind=torch.zeros((M, Nx + 1), dtype=torch.int32, device=device),
        states=torch.zeros((M, Nx * Ny), dtype=torch.int32, device=device),
        Eng=torch.zeros((M,), dtype=torch.float64, device=device),
        prob=prob,
        deg=torch.ones((M,), dtype=torch.int64, device=device),
        valid=valid,
        aidx=torch.arange(M, device=device),
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


def _flagship_body(Es, Esl, Esu, dmap, rmap, X0, betas, ndall, max_scale,
                   EsR, EslR, EsuR, nvalid, cols, beta, *, M, Nx, bits,
                   min_dEng, log2_cutoff, cand, Dmax, tolS, tolV,
                   max_sweeps, lh, lv, pre_Dmax, pre_sweeps, rsvd=True,
                   omega=None, stage_times=None):
    """The single-instance flagship pipeline: balancing beta ladder
    (gauges), gauged Boltzmann and traced row tensors at the target beta,
    the top boundary-MPS stack, and the full beam search.

    The ladder always zips up with the sketch, as tnax's flagship does
    (its ladder reads the ambient default); ``rsvd`` sets the main stack.
    ``stage_times``, if a dict, receives the seconds of the four stages
    (ladder, peps, boundary, search), each ended by a synchronize.
    Returns (beam, aux).
    """
    clock = _StageClock(stage_times, Es.device)
    X, _ = pre._ladder_program(Es, Esl, Esu, dmap, rmap, X0, betas, ndall,
                               max_scale, Dmax=pre_Dmax, tolS=tolS,
                               tolV=tolV, max_sweeps=pre_sweeps, lh=lh,
                               lv=lv, omega=omega)
    clock.lap("ladder")
    lB, Wt = engine.peps_rows(Es, Esl, Esu, dmap, rmap, X["Xl"], X["Xr"],
                              X["Xu"], X["Xd"], beta, lh=lh, lv=lv)
    Ny = Wt.shape[0]
    drindex = dmap.long() * lh + rmap.long()
    grid_in = dict(lB=lB, drindex=drindex, Es=EsR, Esl=EslR, Esu=EsuR,
                   dmap=dmap, rmap=rmap, nvalid=nvalid, cols=cols)
    beam0 = _initial_beam(M, Dmax, Nx, Ny, Es.dtype, Es.device)
    clock.lap("peps")
    rhoT = engine.build_rhoT(Wt, Dmax=Dmax, tolS=tolS, tolV=tolV,
                             max_sweeps=max_sweeps, rsvd=rsvd,
                             omega=omega)[0]
    clock.lap("boundary")
    beam, aux = full_search_scan(beam0, grid_in, rhoT, Wt, M=M, Nx=Nx,
                                 bits=bits, min_dEng=min_dEng,
                                 log2_cutoff=log2_cutoff, cand=cand)
    clock.lap("search")
    return beam, aux


def flagship_search_gs(ins, M=2 ** 10, relative_P_cutoff=1e-6,
                       min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                       max_sweeps=2, cand_factor=8, pre_steps=1, pre_Dmax=8,
                       pre_sweeps=20, max_scale=1024, zipup_rsvd=True,
                       omega=None, stage_times=None):
    """Flagship GS search on ``ins.device`` in ``ins.dtype``: balancing
    preconditioner ladder, boundary build and beam search (tnax's
    ``flagship_search_gs``, topk selection).

    ``cand_factor`` sizes the merge candidate set at ``cand_factor*M``
    (None = the full M*Np expansion; kernel K2 takes at most 8192).
    ``omega`` is the zip-up sketch (see ``bmps.zipup_apply``): a callable
    ``(L, n, k) -> tensor`` or None for the seeded default.

    Returns dict(energy, states, prob, degeneracy, negative_probability,
    negative_probability_core, discarded_probability, merge_overflow,
    count_max), as tnax does; ``energy`` is the beam's float64 energy.
    """
    dtype, dev = ins.dtype, ins.device
    g = engine.pad_grid(ins.problem)
    Ny, Nx, lh, lv = g.Ny, g.Nx, g.lh, g.lv
    bits = max(1, int(np.ceil(np.log2(max(lh, lv)))))
    log2_cutoff = float(np.log2(relative_P_cutoff)) \
        if relative_P_cutoff > 0 else NEG
    cand = None if cand_factor is None else int(cand_factor) * M
    betas = [ins.beta * 2.0 ** (nn - pre_steps) for nn in range(pre_steps)]
    ms = float(2.0 ** np.floor(np.log2(np.sqrt(max_scale))))

    def dev_t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    X0 = {k: dev_t(v) for k, v in engine.identity_gauges(g).items()}
    ndall = dev_t(ins.problem.ld[: Ny - 1], torch.int32)
    EsR, EslR, EsuR = (dev_t(a, torch.float64) for a in
                       _padded_energy_rows_problem(ins.problem))
    cols = (np.arange(Ny)[:, None] * Nx + np.arange(Nx)[None, :]).tolist()
    beam, aux = _flagship_body(
        dev_t(g.Es), dev_t(g.Esl), dev_t(g.Esu), dev_t(g.dmap, torch.int32),
        dev_t(g.rmap, torch.int32), X0, betas, ndall, ms, EsR, EslR, EsuR,
        g.nstates.tolist(), cols, float(ins.beta), M=M, Nx=Nx, bits=bits,
        min_dEng=min_dEng, log2_cutoff=log2_cutoff, cand=cand, Dmax=Dmax,
        tolS=tolS, tolV=tolV, max_sweeps=max_sweeps, lh=lh, lv=lv,
        pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps, rsvd=zipup_rsvd,
        omega=omega, stage_times=stage_times)
    valid = beam["valid"].cpu().numpy()
    Eng = beam["Eng"].cpu().double().numpy()[valid]
    prob = beam["prob"].cpu().double().numpy()[valid]
    deg = beam["deg"].cpu().numpy()[valid]
    states = beam["states"].cpu().numpy()[valid]
    best = int(np.argmin(Eng))
    return dict(energy=float(Eng[best]), states=states[best],
                prob=float(prob[best]), degeneracy=int(deg[best]),
                negative_probability=min(0.0, float(aux["mq"])),
                negative_probability_core=min(0.0, float(aux["mqc"])),
                discarded_probability=float(aux["pd"]),
                merge_overflow=int(aux["ovf"]), count_max=int(aux["cmax"]))


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
