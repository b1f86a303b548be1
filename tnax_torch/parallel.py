"""Device-resident beam search, Gibbs sampling, the functions that run them
on contraction contexts, and the flagship pipelines around them, for one
instance or a fleet.

Counterpart of the single-device ``topk`` path, the context functions
(``device_search_gs``, ``multi_search_gs``, ``device_sample``,
``multi_sample``, ``exact_energies``) and the fused samplers of
``tnax/parallel.py``. They are the one search body and the one
sampling body: the Solver's paths call them on its context, the flagship
pipelines on the context their ladder and boundary stages made.
tnax vmaps one program over a fleet of instances; here every function
carries a written-out leading instance axis B, and the single search is
the fleet of one. One beam step per lattice site and per instance, all
instances in the same launches: conditional marginals (kernel K3 in the
epilogue), each instance's relative cutoff, the top-(C+1) candidates, the
merge of candidates that share a boundary-index vector (kernel K2 groups
them), the top-M groups with exact int64 degeneracy sums, and the
left-environment update. ``lax.scan`` over sites and rows becomes Python
loops; nothing in the per-site loop reads a device value on the host.

The low-energy spectrum's decision records (:func:`row_records_prog`)
run the same site body (:func:`site_step`) and record what each site
decided, for the host replay of ``spectrum``.

Sampling (:func:`flagship_sample`, :func:`multi_flagship_sample`) shares
the pipeline's first three stages with the search and then draws M
walkers per instance site by site (kernel K4 for the site step). tnax
draws with ``jax.random`` inside its scan; here each instance's uniforms
of the pass are drawn up front, or injected by the caller.

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

import numpy as np
import torch

from . import engine
from . import mesh as _mesh
from . import precondition as pre
from .bmps import check_rsvd
from .config import StageClock
from .kernels.marginal import boltzmann_columns
from .search import ContractionContext, fleet_tables
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
# one beam site: the body of the search and of the decision records
# ---------------------------------------------------------------------------

def _compact_candidates(probf, pmax, log2_cutoff, C):
    """tnax's ``compact`` candidate order (parallel.py:621-646), which its
    decision records take at C >= 16*M: every flagged candidate (above
    the cutoff or at pmax, and live), branch by branch, each branch's in
    its own descending order with the lower state first among ties, cut
    at C. When more than C are flagged this is not the global top C.

    probf (B, M, Np), pmax (B,). Returns (vals (B, C) NEG beyond the
    flagged, flat indices (B, C) 0 beyond them, count (B,) of flagged,
    disc (B,) the largest value dropped by the cutoff or the cap).
    """
    B, M, Np = probf.shape
    dev = probf.device
    svals, sidx = torch.sort(probf, dim=2, descending=True, stable=True)
    live = svals > NEG / 2
    flag = ((svals > (pmax + log2_cutoff)[:, None, None])
            | (svals == pmax[:, None, None])) & live
    count = flag.sum(dim=(1, 2))
    # the flagged entries form a prefix of each branch's sorted row; a
    # stable partition puts them first, branch-major
    flat, svals = flag.reshape(B, M * Np), svals.reshape(B, M * Np)
    pos = torch.cumsum(flat, dim=1) - 1
    at = torch.where(flat & (pos < C), pos, C)
    fidx = (torch.arange(M, device=dev)[:, None] * Np + sidx).reshape(B, -1)
    vals = torch.full((B, C + 1), NEG, dtype=probf.dtype, device=dev)
    vals = vals.scatter_(1, at, svals)[:, :C]
    idx = torch.zeros((B, C + 1), dtype=torch.int64, device=dev)
    idx = idx.scatter_(1, at, fidx)[:, :C]
    dropped = (flat & (pos >= C)) | (live.reshape(B, -1) & ~flat)
    disc = torch.where(dropped, svals, NEG).amax(dim=1)
    return vals, idx, count, disc


def site_step(beam, site, *, M, nx, bits, min_dEng, log2_cutoff, C,
              col=None, records=False, compact=False, axis=None):
    """One lattice site of the beam search of B instances, the body that
    :func:`row_step` and :func:`row_records_prog` share: the marginals
    (kernel K3 in the epilogue), each instance's relative cutoff, the
    candidates, the merge of those that share a boundary-index vector
    (kernel K2 groups them), the top-M groups with exact int64
    degeneracy sums, the parents' gathers and the left-environment
    update. Nothing is read on the host.

    beam: RL (B, M, D), vind (B, M, Nx+1) int32, Eng (B, M) float64, prob
      (B, M), valid (B, M) bool, aidx (B, M); deg (B, M) int64 and states
      (B, M, L) int32 where the caller keeps them (``col`` is then the
      site's state column).
    site: lBT (B, lh, lv, Np), drindex (B, Np) int64, AT (B, D, lv, D),
      RRs (B, M, D, lh) (the row-start right environments of the site), Es
      (B, Np), Esl (B, Np, lh), Esu (B, Np, lv) raw float64, dmap/rmap (B,
      Np), nvalid (B,) int64.

    Candidates: the prob-ordered top C of the M*Np expansion (lax.top_k's
    order), or with ``compact`` tnax's branch-major order
    (:func:`_compact_candidates`). ``records`` takes the diagnostics of
    tnax's decision records instead of its search's: count = the
    candidates above the cutoff without the live mask (topk) or the
    flagged ones (compact), and disc = the first value dropped by the
    cutoff or the cap.

    ``axis`` (a ``mesh.MeshAxis``, tnax's 'beam' axis) shards the M
    branches over its n ranks (tnax parallel.py:226-470, :573-790): the
    beam holds this rank's M/n branches (aidx global row-start ids into
    the RRs of all M), the cutoff and the core window take the global
    pmax, each rank takes its local top C (the caller's per-rank cap) and
    the merge runs on every rank over the candidates of all ranks,
    gathered rank-major, with the parents' rows gathered for key1 and
    the winners; the rank keeps its M/n slice of the output. count, disc
    and mq stay local (the caller reduces them); mqc is taken with the
    global bmax.

    Returns (beam', dec): dec holds (B, ...) tensors of the decisions, src
    and indc (B, C) each candidate's parent slot and state, vals (B, C)
    its log2-probability, slot (B, C) the output slot it merged into (-1:
    none), rep (B, M) each slot's representative candidate, out_prob and
    out_valid (B, M) the merged beam's, count, disc, disc_m (the largest
    group the top-M cut dropped), mq and mqc (B,). With ``axis`` the
    candidates (C) are all ranks' and src holds global parent ids.
    """
    B, Np = site["lBT"].shape[0], site["lBT"].shape[-1]
    kb = (M - 1).bit_length() + 2 * bits + 1
    RL, vind, Eng, prob, valid, aidx = (
        beam[k] for k in ("RL", "vind", "Eng", "prob", "valid", "aidx"))
    N = RL.shape[1] * Np
    dev = RL.device
    take = engine._take
    AT = site["AT"]
    dmap, rmap = site["dmap"].long(), site["rmap"].long()
    RRsel = take(site["RRs"], aidx)
    lidx = vind[:, :, nx].long()
    uidx = vind[:, :, nx + 1].long()
    # Einc[b, m, p] = Eng[m] + Es[p] + Esl[p, lidx_m] + Esu[p, uidx_m];
    # the picks are exact gathers, in tnax's addition order
    Einc = ((Eng[:, :, None] + site["Es"][:, None, :])
            + take(site["Esl"].transpose(1, 2), lidx)) \
        + take(site["Esu"].transpose(1, 2), uidx)
    # the epilogue (K3) also takes the site's reductions: pmax, and the
    # negativeness of live (mq) and of core branches (mqc)
    probf, mPn, pmax, mq, mqc = engine.marginal_probf(
        site["lBT"], site["drindex"], AT, RL, RRsel, lidx, uidx,
        site["nvalid"], prob, valid, log2_cutoff)
    if axis is not None:
        if compact:
            raise ValueError("the sharded site takes the topk candidates")
        # the global pmax and best branch; K3's mqc used the local one
        bmax = torch.where(valid, prob, NEG).amax(dim=1)
        pmax, bmax = _mesh.pmax(torch.stack([pmax, bmax]), axis)
        core = valid & (prob > (bmax + log2_cutoff)[:, None])
        mqc = torch.where(core, mPn, 0.0).amin(dim=1)
    neg = torch.full((B,), NEG, dtype=probf.dtype, device=dev)
    if compact:
        vals_c, idx_c, count, disc = _compact_candidates(probf, pmax,
                                                         log2_cutoff, C)
        cvalid = torch.arange(C, device=dev) < torch.clamp(count,
                                                           max=C)[:, None]
    else:
        probf = probf.reshape(B, N)
        cutoff = pmax[:, None] + log2_cutoff
        # prob-ordered top-C candidates (+1 to see the cap's first casualty)
        k = min(C + 1, N)
        vals, idx = _top_k(probf, k)
        if records:
            count = (probf > cutoff).sum(dim=1)
            kk = torch.clamp(count, max=C)
            at = torch.clamp(kk, 0, k - 1)[:, None]
            disc = torch.where(kk < N, vals.gather(1, at)[:, 0], neg)
        else:
            count = ((probf > cutoff) & (probf > NEG / 2)).sum(dim=1)
            disc = neg
            if C < N:
                disc = torch.where(count > C, vals[:, min(C, k - 1)], neg)
            at = torch.clamp(count, 0, k - 1)[:, None]
            disc = torch.maximum(disc, torch.where(
                count < N, vals.gather(1, at)[:, 0], neg))
        vals_c, idx_c = vals[:, :C], idx[:, :C]
        live = vals_c > NEG / 2
        # the best branch always survives, even below the cutoff
        cvalid = (valid.gather(1, idx_c // Np) & (vals_c > cutoff) & live) \
            | ((vals_c == pmax[:, None]) & live)
    src = idx_c // Np
    indc = idx_c % Np
    E_cand = Einc.reshape(B, N).gather(1, idx_c)
    parents = {k: beam[k] for k in ("vind", "RL", "aidx", "deg", "states")
               if k in beam}
    rows = slice(None)
    if axis is not None:
        # every rank's candidates, rank-major, with global parent ids, and
        # the parents of all ranks (vind-unique over the whole beam, so
        # key1 below stays exact); then this rank's slice of the merge
        src = src + axis.index * beam["RL"].shape[1]
        vals_c, E_cand, indc, cvalid, src = (
            _mesh.all_gather(x, axis, dim=1)
            for x in (vals_c, E_cand, indc, cvalid, src))
        parents = {k: _mesh.all_gather(v, axis, dim=1)
                   for k, v in parents.items()}
        rows = axis.block(M)
    vind = parents["vind"]

    d_c, r_c = dmap.gather(1, indc), rmap.gather(1, indc)
    vind_c = take(vind, src)
    vind_c[:, :, nx] = d_c.to(vind.dtype)
    vind_c[:, :, nx + 1] = r_c.to(vind.dtype)

    key1 = None
    if kb <= 31:
        # candidates share a vind row iff their parents' groups over the
        # other columns and their (dmap, rmap) coincide; parents are
        # vind-unique, so one lexsort of M rows gives the groups
        vind_p = vind.clone()
        vind_p[:, :, nx] = 0
        vind_p[:, :, nx + 1] = 0
        perm_p = _lexsort(pack_keys(vind_p, bits))
        vp = take(vind_p, perm_p)
        seg_p = torch.cat([
            torch.zeros((B, 1), dtype=torch.int64, device=dev),
            torch.cumsum((vp[:, 1:] != vp[:, :-1]).any(dim=2), 1)], dim=1)
        gid = torch.empty_like(seg_p).scatter(1, perm_p, seg_p)
        key1 = ((gid.gather(1, src) << (2 * bits + 1))
                | (d_c << (bits + 1)) | (r_c << 1)
                | (1 - cvalid.long())).to(torch.int32)
    deg = parents.get("deg")
    deg_c = torch.ones_like(src) if deg is None else deg.gather(1, src)
    slot, rep, prob_o, Eng_o, valid_o, disc_m, deg_o = merge_candidates(
        vind_c, E_cand, vals_c, cvalid, min_dEng, bits, M, deg_c, key1=key1,
        key_bits=kb)
    rep_o = rep[:, rows]
    bsrc = src.gather(1, rep_o)
    vind_o = take(vind_c, rep_o)
    out = dict(RL=engine.rl_update(take(parents["RL"], bsrc), AT,
                                   vind_o[:, :, nx]),
               vind=vind_o, Eng=Eng_o[:, rows], prob=prob_o[:, rows],
               valid=valid_o[:, rows], aidx=parents["aidx"].gather(1, bsrc))
    if deg is not None:
        out["deg"] = deg_o[:, rows]
    if "states" in parents:
        states = take(parents["states"], bsrc)
        states[:, :, col] = indc.gather(1, rep_o).to(states.dtype)
        out["states"] = states
    dec = dict(src=src, indc=indc, vals=vals_c, slot=slot, rep=rep,
               out_prob=prob_o, out_valid=valid_o, count=count, disc=disc,
               disc_m=disc_m, mq=mq, mqc=mqc)
    return out, dec


def _site(row, nx):
    """Site nx of a row's per-site stacks (B, Nx, ...)."""
    return {k: v[:, nx] for k, v in row.items() if k != "cols"}


def _shift_vind(vind):
    """Shift each branch's boundary indices for the next row (reference
    tnac4o/tnac4o.py:540-542)."""
    return torch.cat([torch.zeros_like(vind[:, :, :1]), vind[:, :, :-1]],
                     dim=2)


def row_step(beam, row, *, M, Nx, bits, min_dEng, log2_cutoff, cand=None,
             axis=None):
    """Process one full lattice row of the beam search of B instances on
    the device: :func:`site_step` for every site, with the search's
    diagnostics.

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

    ``cand=None`` is the full M*Np expansion. Every instance has its own
    cutoff, counts and diagnostics. Returns (beam', aux) with aux =
    dict(mq, mqc, pd, ovf, cmax) of (B,) device tensors (no host sync).

    ``axis`` (tnax's 'beam' axis, a ``mesh.MeshAxis`` of n ranks) shards
    the branches as tnax's ``row_step(axis=...)`` does: the beam holds
    this rank's M/n branches, aidx their global ids into RRs of all M;
    each rank takes C_local = min(max(1, C // n), (M/n)*Np) candidates a
    site; a site overflows when any rank truncated, cmax is the largest
    summed count, and aux is the same on every rank.
    """
    Np = row["lBT"].shape[-1]
    C = min(cand if cand is not None else M * Np, M * Np)
    if axis is not None:
        C = min(max(1, C // axis.size), (M // axis.size) * Np)
    decs = []
    for nx in range(Nx):
        beam, dec = site_step(beam, _site(row, nx), M=M, nx=nx, bits=bits,
                              min_dEng=min_dEng, log2_cutoff=log2_cutoff,
                              C=C, col=row["cols"][nx], axis=axis)
        decs.append(dec)
    beam = dict(beam, vind=_shift_vind(beam["vind"]))

    def over_sites(k):
        return torch.stack([d[k] for d in decs], 1)
    count = over_sites("count")
    aux = dict(mq=_mesh.pmin(over_sites("mq").amin(1), axis),
               mqc=_mesh.pmin(over_sites("mqc").amin(1), axis),
               pd=_mesh.pmax(torch.maximum(over_sites("disc"),
                                           over_sites("disc_m")).amax(1),
                             axis),
               ovf=_mesh.pmax((count > C).long(), axis).sum(1),
               cmax=_mesh.psum(count, axis).amax(1))
    return beam, aux


_AUX_REDUCE = dict(mq=torch.amin, mqc=torch.amin, pd=torch.amax,
                   ovf=torch.sum, cmax=torch.amax)


def _right_envs(AT_row, Wt_row, vind, axis=None):
    """The row-start right environments (B, Nx, M, D, lh) of every
    branch; with a beam ``axis`` each rank computes its own branches' and
    gathers all M, the same on every rank."""
    RRs = engine.row_right_envs(AT_row, Wt_row, vind[:, :, 1:])
    return _mesh.all_gather(RRs, axis, dim=2)


def _row_inputs(grid_in, rhoT, Wt, beam, ny, axis=None):
    """Row ny's per-site stacks from the search's (B, Ny, ...) inputs,
    with the boundary below the row and every branch's right
    environments."""
    row = {k: v[ny] if k == "cols" else v[:, ny] for k, v in grid_in.items()}
    row.update(AT=rhoT[:, ny + 1],
               RRs=_right_envs(rhoT[:, ny + 1], Wt[:, ny], beam["vind"],
                               axis))
    return row


def _beam_ids(B, M, device, axis=None):
    """The row-start ids of a beam of M branches (B, M), or of this
    rank's block of them on a beam ``axis``."""
    ids = torch.arange(M, device=device).expand(B, M)
    return ids if axis is None else ids[:, axis.block(M)]


def full_search_scan(beam0, grid_in, rhoT, Wt, *, M, Nx, bits, min_dEng,
                     log2_cutoff, cand=None, axis=None):
    """The whole ground-state search of B instances: per lattice row, the
    right environments of every branch, then :func:`row_step`'s site loop.

    grid_in: dict of (B, Ny, ...) stacks lBT, drindex, Es, Esl, Esu,
    dmap, rmap, nvalid (B, Ny, Nx) on the device (as :func:`row_step`
    takes them), and the host list cols (Ny, Nx). rhoT (B, Ny+1, Nx, D,
    lv, D), Wt (B, Ny, Nx, lh, lv, lh, lv). With a beam ``axis`` beam0 is
    this rank's block of the branches (see :func:`row_step`).
    Returns (beam, aux) with aux reduced over rows, per instance.
    """
    B, D = rhoT.shape[0], rhoT.shape[3]
    Ny = Wt.shape[1]
    beam = dict(beam0)
    auxs = []
    for ny in range(Ny):
        beam["aidx"] = _beam_ids(B, M, rhoT.device, axis)
        beam["RL"] = _unit_rows(B, beam["aidx"].shape[1], D, rhoT)
        row = _row_inputs(grid_in, rhoT, Wt, beam, ny, axis)
        beam, aux = row_step(beam, row, M=M, Nx=Nx, bits=bits,
                             min_dEng=min_dEng, log2_cutoff=log2_cutoff,
                             cand=cand, axis=axis)
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


# ---------------------------------------------------------------------------
# per-site decision records of the spectrum search
# ---------------------------------------------------------------------------

# the fields of a site's record: name, dtype, length per site (P: the pull
# cap, M: the beam, None: one value). The probabilities are float32 in
# either compute dtype, as tnax's records hold them (_f32bits), and the
# replay reads them as such.
RECORD_FIELDS = (("src", torch.int32, "P"), ("indc", torch.int32, "P"),
                 ("slot", torch.int32, "P"), ("rep", torch.int32, "M"),
                 ("cprob", torch.float32, "P"),
                 ("out_prob", torch.float32, "M"),
                 ("out_valid", torch.bool, "M"),
                 ("n_valid", torch.int32, None), ("count", torch.int32, None),
                 ("disc_cut", torch.float32, None),
                 ("disc_m", torch.float32, None),
                 ("minP", torch.float32, None),
                 ("minP_core", torch.float32, None))


def _f32(x):
    """x rounded to float32 with subnormals flushed to zero (keeping the
    sign), as tnax's records hold their probabilities (XLA's conversion
    flushes)."""
    y = x.to(torch.float32)
    return torch.where(y.abs() < torch.finfo(torch.float32).tiny, y * 0, y)


def record_layout(B, Nx, M, P):
    """(bytes, [(name, dtype, shape, offset)]) of one row's records of B
    instances: every field (B, Nx, ...) in one buffer, 8-byte aligned, so
    a row leaves the device in one copy."""
    fields, off = [], 0
    for name, dt, n in RECORD_FIELDS:
        shape = (B, Nx) + ({"P": (P,), "M": (M,), None: ()}[n])
        fields.append((name, dt, shape, off))
        off += -(-int(np.prod(shape)) * dt.itemsize // 8) * 8
    return off, fields


def record_views(buf, layout):
    """The fields of a row's record buffer ``buf`` (uint8, on any device)
    as typed (B, Nx, ...) views."""
    return {name: buf[off:off + int(np.prod(shape)) * dt.itemsize]
            .view(dt).view(shape) for name, dt, shape, off in layout[1]}


def row_records_prog(beam, row, AT_row, Wt_row, *, M, C, Nx, bits, min_dEng,
                     log2_cutoff, P=None, select="topk", rec=None,
                     axis=None):
    """One lattice row of the search of B instances, emitting per-site
    decision records (tnax's ``row_records_prog`` / ``_records_row_core``,
    parallel.py:534-790, with the instance axis): every beam decision is
    made on the device by :func:`site_step`, and the record says what was
    decided, for the host to replay exact float64 energies, states,
    degeneracies and droplet trees.

    beam: vind (B, M, Nx+1) int32, Eng (B, M) float64, prob (B, M), valid
    (B, M). row: the per-site stacks of :func:`row_step` without AT and
    RRs, which come from the boundary row AT_row (B, Nx, D, lv, D) and
    Wt_row. C is the candidate cap; ``select`` "topk" (the prob-ordered
    top C) or "compact" (tnax's branch-major order, which it takes at C >=
    16*M). P (default C) is the pull cap: the candidates are stably sorted
    by slot, the merged ones first, and the first P are recorded, with rep
    remapped into that prefix and clamped; n_valid > P flags the site.

    Writes the fields of :data:`RECORD_FIELDS` into ``rec`` (views (B,
    Nx, ...), e.g. :func:`record_views` of a row buffer; allocated if
    None). Returns (beam', rec).

    ``axis`` (tnax's 'beam' axis of n ranks, ``_records_row_core`` with
    its axis; C a multiple of n, ValueError otherwise) shards the
    branches: the beam holds this rank's M/n branches, each rank takes its
    top C/n candidates (the "topk" order), and the records, built after
    the gathers with global parent ids, the summed count (raised to C+1
    where any rank truncated) and the global disc_cut, minP and
    minP_core, are the same on every rank.
    """
    if select not in ("topk", "compact"):
        raise ValueError(f"records select 'topk' or 'compact', got "
                         f"{select!r}")
    B, D = AT_row.shape[0], AT_row.shape[2]
    dev = AT_row.device
    P = C if P is None else min(P, C)
    Cl = C
    if axis is not None:
        if C % axis.size:
            raise ValueError(f"C={C} does not tile the beam axis "
                             f"({axis.size})")
        Cl = max(1, C // axis.size)
    if rec is None:
        layout = record_layout(B, Nx, M, P)
        rec = record_views(torch.empty(layout[0], dtype=torch.uint8,
                                       device=dev), layout)
    aidx = _beam_ids(B, M, dev, axis)
    beam = dict(beam, RL=_unit_rows(B, aidx.shape[1], D, AT_row), aidx=aidx)
    row = dict(row, AT=AT_row,
               RRs=_right_envs(AT_row, Wt_row, beam["vind"], axis))
    pos = torch.arange(C, device=dev).expand(B, C)
    for nx in range(Nx):
        beam, dec = site_step(beam, _site(row, nx), M=M, nx=nx, bits=bits,
                              min_dEng=min_dEng, log2_cutoff=log2_cutoff,
                              C=Cl, records=True,
                              compact=select == "compact", axis=axis)
        if axis is not None:
            trunc = _mesh.pmax((dec["count"] > Cl).long(), axis) > 0
            count = _mesh.psum(dec["count"], axis)
            dec.update(count=torch.where(trunc, torch.clamp(count, min=C + 1),
                                         count),
                       disc=_mesh.pmax(dec["disc"], axis),
                       mq=_mesh.pmin(dec["mq"], axis),
                       mqc=_mesh.pmin(dec["mqc"], axis))
        slot, valid = dec["slot"], dec["out_valid"]
        # compaction: the merged candidates (slot >= 0) first, by slot;
        # the sort is stable, so a slot keeps the candidates' order
        full = torch.sort(torch.where(slot >= 0, slot, C), dim=1,
                          stable=True).indices
        tk = full[:, :P]
        inv = torch.empty_like(full).scatter_(1, full, pos)
        rep = torch.clamp(torch.where(valid, inv.gather(1, dec["rep"]), 0),
                          0, P - 1)
        for name, x in (("src", dec["src"].gather(1, tk)),
                        ("indc", dec["indc"].gather(1, tk)),
                        ("slot", slot.gather(1, tk)), ("rep", rep),
                        ("cprob", _f32(dec["vals"].gather(1, tk))),
                        ("out_prob", _f32(dec["out_prob"])),
                        ("out_valid", valid),
                        ("n_valid", (slot >= 0).sum(dim=1)),
                        ("count", dec["count"]),
                        ("disc_cut", _f32(dec["disc"])),
                        ("disc_m", _f32(dec["disc_m"])),
                        ("minP", _f32(dec["mq"])),
                        ("minP_core", _f32(dec["mqc"]))):
            rec[name][:, nx] = x
    beam = {k: beam[k] for k in ("vind", "Eng", "prob", "valid")}
    beam["vind"] = _shift_vind(beam["vind"])
    return beam, rec


def search_inputs(ctx):
    """The search's (B, Ny, ...) per-site stacks of a contraction context:
    the Boltzmann tables with the states last (made once per search, so a
    branch's column is one contiguous run for the epilogue K3), drindex,
    the raw float64 energy tables, dmap, rmap and nvalid on the device,
    and the host list cols."""
    f = ctx.tables
    Es, Esl, Esu = ctx.energy_rows()
    return dict(lBT=boltzmann_columns(ctx.lB), drindex=ctx.drindex, Es=Es,
                Esl=Esl, Esu=Esu, dmap=f["dmap"], rmap=f["rmap"],
                nvalid=f["nvalid"], cols=f["cols"])


# ---------------------------------------------------------------------------
# the flagship pipelines
# ---------------------------------------------------------------------------

def _check_select(select):
    """tnax's ``select``: "topk" and "sort" are bit-identical selections,
    both the port's stable sort; its "radix" and "compact" modes are not
    ported (measured no faster than topk)."""
    if select not in ("topk", "sort"):
        raise ValueError(f"select must be 'topk' or 'sort', got {select!r} "
                         f"('radix' and 'compact' are not ported)")


def _boundary_stages(solvers, f, clock, *, pre_steps, max_scale, Dmax, tolS,
                     tolV, max_sweeps, pre_Dmax, pre_sweeps, rsvd, omega):
    """Stages 1-3 of the flagship pipelines of B instances (the fleet
    ``f`` of ``search.fleet_tables``): the balancing beta ladder
    (gauges), the contraction context at the target beta (the gauged
    Boltzmann and traced row tensors) and its top boundary-MPS stacks.
    The ladder always zips up with the sketch, as tnax's flagship does
    (its ladder reads the ambient default); ``rsvd`` sets the main stack.
    Returns the context."""
    X, _ = pre._ladder_program(f["Es"], f["Esl"], f["Esu"], f["dmap"],
                               f["rmap"], f["X0"],
                               pre.ladder_betas(f["beta"], pre_steps),
                               f["ndall"], pre.ladder_max_scale(max_scale),
                               Dmax=pre_Dmax, tolS=tolS, tolV=tolV,
                               max_sweeps=pre_sweeps, lh=f["lh"], lv=f["lv"],
                               omega=omega)
    clock.lap("ladder")
    ctx = ContractionContext(solvers, X, tables=f)
    clock.lap("peps")
    ctx.build_boundary(Dmax, tolS, tolV, max_sweeps, rsvd=rsvd, omega=omega)
    clock.lap("boundary")
    return ctx


def _one(ctx, name):
    if ctx.B != 1:
        raise ValueError(f"{name} takes a context of one instance, got "
                         f"{ctx.B}")


def multi_search_gs(ctxs, M=2 ** 10, relative_P_cutoff=1e-6, min_dEng=1e-12,
                    Dmax=32, tolS=1e-16, tolV=1e-10, max_sweeps=20,
                    graduate_truncation=True, mesh=None, cand_factor=8,
                    select="topk", zipup_rsvd=None, omega=None,
                    stage_times=None):
    """Device-resident ground-state search of same-shape instances (tnax's
    ``multi_search_gs``, with its arguments): the contexts ``ctxs`` are
    stacked along the instance axis (``ContractionContext.stack``), and
    every stage runs once for all of them; the beams never leave the
    device until the end. The search body of the Solver's
    ``path="device"`` and of the flagship pipelines.

    The boundary stacks are built (``zipup_rsvd`` and ``omega`` set the
    zip-up, see ``ContractionContext.build_boundary``) unless the stacked
    context holds them at ``Dmax``. ``cand_factor`` sizes each instance's
    merge candidate set at ``cand_factor*M`` (None = the full M*Np
    expansion, the uncapped exact merge; kernel K2 takes any cap).
    ``select`` is "topk" or "sort" (the same selection);
    ``graduate_truncation`` has no effect on the zip-up. With ``mesh``
    (``make_mesh``; every rank passes all the contexts) the instances
    shard over its 'data' axis, pure data parallelism as tnax's: the first
    beam rank of each data group searches its block of len(ctxs) /
    n_data instances (ValueError unless they tile the axis), and every
    rank returns the results of all. ``stage_times``, if a dict, receives
    the seconds of the boundary (when built here) and of the search.

    Returns a list with one dict(energy, states, prob, degeneracy,
    negative_probability, negative_probability_core,
    discarded_probability, merge_overflow, count_max) per instance, as
    tnax does; ``energy`` is the beam's float64 energy.
    """
    if mesh is not None:
        ctxs = list(ctxs)
        block = _mesh.check_mesh(mesh).block(len(ctxs), "data")
        local = None
        if mesh.index("beam") == 0:
            local = multi_search_gs(
                ctxs[block], M=M, relative_P_cutoff=relative_P_cutoff,
                min_dEng=min_dEng, Dmax=Dmax, tolS=tolS, tolV=tolV,
                max_sweeps=max_sweeps,
                graduate_truncation=graduate_truncation,
                cand_factor=cand_factor, select=select,
                zipup_rsvd=zipup_rsvd, omega=omega, stage_times=stage_times)
        return _mesh.gather_data(local, mesh)
    ctx = ContractionContext.stack(list(ctxs))
    _check_select(select)
    check_rsvd(zipup_rsvd)
    with StageClock(stage_times, ctx.device) as clock:
        if ctx.rhoT is None or ctx.Dmax != Dmax:
            ctx.build_boundary(Dmax, tolS, tolV, max_sweeps,
                               graduate_truncation, rsvd=zipup_rsvd,
                               omega=omega)
            clock.lap("boundary")
        bits = max(1, int(np.ceil(np.log2(max(ctx.lh, ctx.lv)))))
        log2_cutoff = float(np.log2(relative_P_cutoff)) \
            if relative_P_cutoff > 0 else NEG
        cand = None if cand_factor is None else int(cand_factor) * M
        beam0 = _initial_beam(ctx.B, M, ctx.Dmax, ctx.Nx, ctx.Ny, ctx.dtype,
                              ctx.device)
        beam, aux = full_search_scan(beam0, search_inputs(ctx), ctx.rhoT,
                                     ctx.Wt, M=M, Nx=ctx.Nx, bits=bits,
                                     min_dEng=min_dEng,
                                     log2_cutoff=log2_cutoff, cand=cand)
        clock.lap("search")
    return _assemble_batched_results(beam, aux)


def _assemble_batched_results(beam, aux):
    """Each instance's result dict from the final beams (B, M) and the
    search's diagnostics (B,): the best valid branch's state, energy,
    probability and degeneracy (tnax's ``_assemble_batched_results``),
    after one pull of what they need."""
    host = {k: beam[k].cpu().numpy()
            for k in ("valid", "Eng", "prob", "deg", "states")}
    aux = {k: v.cpu().numpy() for k, v in aux.items()}
    results = []
    for b in range(len(host["valid"])):
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


def device_search_gs(ctx, M=2 ** 10, relative_P_cutoff=1e-6, min_dEng=1e-12,
                     Dmax=32, tolS=1e-16, tolV=1e-10, max_sweeps=20,
                     graduate_truncation=True, fused=True, cand_factor=8,
                     select="topk", zipup_rsvd=None, omega=None,
                     stage_times=None):
    """Device-resident ground-state search of the one instance of ``ctx``
    (tnax's ``device_search_gs``, with its arguments): the boundary stack
    is built unless the context holds it at ``Dmax``, then the whole beam
    search runs on the device. tnax's ``fused`` picks one of two forms of
    the same search; both run the port's one form. Returns the dict of
    :func:`multi_search_gs`, whose other arguments it shares."""
    _one(ctx, "device_search_gs")
    return multi_search_gs(
        [ctx], M=M, relative_P_cutoff=relative_P_cutoff, min_dEng=min_dEng,
        Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        graduate_truncation=graduate_truncation, cand_factor=cand_factor,
        select=select, zipup_rsvd=zipup_rsvd, omega=omega,
        stage_times=stage_times)[0]


def multi_flagship_search_gs(solvers, M=2 ** 10, relative_P_cutoff=1e-6,
                             min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                             max_sweeps=2, graduate_truncation=True,
                             cand_factor=8, select="topk", pre_steps=1,
                             pre_Dmax=8, pre_sweeps=20, max_scale=1024,
                             zipup_rsvd=None, omega=None, stage_times=None):
    """Fleet GS search: the flagship pipeline (balancing ladder, boundary
    build, beam search) run once over a batch of same-shape Solver
    instances, every stage with a leading instance axis (tnax's
    ``multi_flagship_search_gs``, with its arguments). Each instance's
    result is the one :func:`flagship_search_gs` gives it alone.

    The instances must share (Ny, Nx, Np, lh, lv), beta, device and dtype
    (ValueError otherwise). The ladder's gauges and the boundary stacks
    (``zipup_rsvd`` and ``omega``, the zip-up sketch shared by the fleet,
    see ``bmps.zipup_apply``) make one context of the fleet, which
    :func:`multi_search_gs` searches with ``cand_factor`` and ``select``.
    ``stage_times``, if a dict, receives the seconds of the four stages
    (ladder, peps, boundary, search) of the whole batch, the ladder's
    sub-spans and the counters (``config.StageClock``). Returns
    :func:`multi_search_gs`'s list.
    """
    _check_select(select)
    check_rsvd(zipup_rsvd)
    f = fleet_tables(solvers)
    with StageClock(stage_times, f["device"]) as clock:
        ctx = _boundary_stages(
            solvers, f, clock, pre_steps=pre_steps, max_scale=max_scale,
            Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
            pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps, rsvd=zipup_rsvd,
            omega=omega)
        return multi_search_gs(
            [ctx], M=M, relative_P_cutoff=relative_P_cutoff, min_dEng=min_dEng,
            Dmax=Dmax, cand_factor=cand_factor, select=select,
            stage_times=stage_times)


def flagship_search_gs(ins, M=2 ** 10, relative_P_cutoff=1e-6,
                       min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                       max_sweeps=2, graduate_truncation=True,
                       cand_factor=8, select="topk", pre_steps=1, pre_Dmax=8,
                       pre_sweeps=20, max_scale=1024, zipup_rsvd=None,
                       omega=None, stage_times=None):
    """Flagship GS search on ``ins.device`` in ``ins.dtype``: balancing
    preconditioner ladder, boundary build and beam search (tnax's
    ``flagship_search_gs``, with its arguments). It is the fleet of one:
    :func:`multi_flagship_search_gs` with B = 1, whose arguments and
    result keys it shares.
    """
    return multi_flagship_search_gs(
        [ins], M=M, relative_P_cutoff=relative_P_cutoff, min_dEng=min_dEng,
        Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        graduate_truncation=graduate_truncation, cand_factor=cand_factor,
        select=select, pre_steps=pre_steps, pre_Dmax=pre_Dmax,
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
    return dict(RL=RL, vind=_shift_vind(vind), states=states), mq


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
        row = _row_inputs(grid_in, rhoT, Wt, beam, ny)
        beam, mq = sample_rows(beam, row, u[:, ny], M=M, Nx=Nx)
        mqs.append(mq)
    return beam, torch.stack(mqs, 1).amin(1)


def instance_uniforms(seed, b, shape, dtype, device):
    """The uniforms of instance b of a fleet sampled with ``seed``: one
    draw of ``shape`` in [0, 1) from a generator on ``device`` seeded from
    (seed, b) alone, so an instance's samples do not depend on the fleet
    it runs in."""
    state = np.random.SeedSequence([seed, b]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) >> 1)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def multi_sample(ctxs, M=2 ** 10, Dmax=32, tolS=1e-15, tolV=1e-10,
                 max_sweeps=20, graduate_truncation=True, seed=0, omega=None,
                 uniforms=None, stage_times=None):
    """Device-resident Gibbs sampling of same-shape instances (tnax's
    ``multi_sample``, with its arguments): the contexts ``ctxs`` are
    stacked along the instance axis (``ContractionContext.stack``), the
    boundary stacks are built unless the stacked context holds them at
    ``Dmax`` (``omega``: the zip-up sketch), then one M-walker sampling
    pass of every instance runs on the device (kernel K4 for each site
    step). The sampling body of the Solver's two paths and of the
    flagship pipelines.

    Random numbers: with ``uniforms=None`` instance b of the stack draws
    its (Ny, Nx, M) uniforms of the pass from its own generator on the
    device, seeded from (seed, b) alone (:func:`instance_uniforms`; tnax
    folds b into a jax key instead); ``uniforms`` (B, Ny, Nx, M) in [0, 1)
    injects them, walker m at site (ny, nx) using ``uniforms[b, ny, nx,
    m]``. ``stage_times``, if a dict, receives the seconds of the boundary
    (when built here) and of the pass.

    Returns a list with one dict(states (M, Ny*Nx) int32 block states,
    energy (M,) exact float64 energies replayed on the host,
    negative_probability) per instance, as tnax does.
    """
    ctx = ContractionContext.stack(list(ctxs))
    B, Ny, Nx = ctx.B, ctx.Ny, ctx.Nx
    dtype, dev = ctx.dtype, ctx.device
    shape = (B, Ny, Nx, M)
    if uniforms is None:
        u = torch.stack([instance_uniforms(seed, b, shape[1:], dtype, dev)
                         for b in range(B)])
    else:
        u = torch.as_tensor(uniforms, device=dev).to(dtype)
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms must have shape {shape} "
                             f"(B, Ny, Nx, M), got {tuple(u.shape)}")
    with StageClock(stage_times, dev) as clock:
        if ctx.rhoT is None or ctx.Dmax != Dmax:
            ctx.build_boundary(Dmax, tolS, tolV, max_sweeps,
                               graduate_truncation, omega=omega)
            clock.lap("boundary")
        f = ctx.tables
        # the Boltzmann tables with the states last, made once per pass, as
        # for the search: a walker's column is one contiguous run for K4
        grid_in = dict(lBT=boltzmann_columns(ctx.lB), drindex=ctx.drindex,
                       dmap=f["dmap"], rmap=f["rmap"], nvalid=f["nvalid"],
                       cols=f["cols"])
        beam0 = dict(RL=_unit_rows(B, M, ctx.Dmax, ctx.rhoT),
                     vind=torch.zeros((B, M, Nx + 1), dtype=torch.int32,
                                      device=dev),
                     states=torch.zeros((B, M, Nx * Ny), dtype=torch.int32,
                                        device=dev))
        beam, mq = full_sample_scan(beam0, grid_in, ctx.rhoT, ctx.Wt, u, M=M,
                                    Nx=Nx)
        clock.lap("sample")
    states, mq = beam["states"].cpu().numpy(), mq.cpu().numpy()  # one pull
    return [dict(states=states[b],
                 energy=exact_energies_problem(p, states[b]),
                 negative_probability=min(0.0, float(mq[b])))
            for b, p in enumerate(ctx.problems)]


def device_sample(ctx, M=2 ** 10, Dmax=32, tolS=1e-15, tolV=1e-10,
                  max_sweeps=20, graduate_truncation=True, seed=0, omega=None,
                  uniforms=None, stage_times=None):
    """Device-resident Gibbs sampling of the one instance of ``ctx``
    (tnax's ``device_sample``, with its arguments): :func:`multi_sample`
    of the context, so ``seed`` gives the uniforms of instance 0 of a
    fleet, and ``uniforms`` (Ny, Nx, M) injects them. Returns
    dict(states, energy, negative_probability)."""
    _one(ctx, "device_sample")
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms)[None]
    return multi_sample([ctx], M=M, Dmax=Dmax, tolS=tolS, tolV=tolV,
                        max_sweeps=max_sweeps,
                        graduate_truncation=graduate_truncation, seed=seed,
                        omega=omega, uniforms=uniforms,
                        stage_times=stage_times)[0]


def multi_flagship_sample(solvers, M=2 ** 10, Dmax=32, tolS=1e-15,
                          tolV=1e-10, max_sweeps=20,
                          graduate_truncation=True, seed=0, pre_steps=1,
                          pre_Dmax=8, pre_sweeps=20, max_scale=1024,
                          zipup_rsvd=None, mesh=None, omega=None,
                          uniforms=None, stage_times=None):
    """Fleet Gibbs sampling: the sampling pipeline (balancing ladder,
    boundary build, M-walker sampling pass) run once over a batch of
    same-shape Solver instances, every stage with a leading instance axis
    (tnax's ``multi_flagship_sample``, with its arguments; the reference's
    production pattern of e02). With ``mesh`` (``make_mesh``; every rank
    passes all the solvers) the instances shard over its 'data' axis, pure
    data parallelism as tnax's: the first beam rank of each data group
    samples its block (ValueError unless the instances tile the axis),
    instance b still on the uniforms of (seed, b), so the states are
    those of the run without a mesh; every rank returns all the results.

    The instances must share (Ny, Nx, Np, lh, lv), beta, device and dtype
    (ValueError otherwise). The ladder's gauges and the boundary stacks
    (``zipup_rsvd`` and ``omega``, see :func:`multi_flagship_search_gs`)
    make one context of the fleet, which :func:`multi_sample` samples with
    ``seed`` or the injected ``uniforms`` (B, Ny, Nx, M).
    ``stage_times``, if a dict, receives the seconds of the four stages
    (ladder, peps, boundary, sample) of the whole batch. Returns
    :func:`multi_sample`'s list.
    """
    if mesh is not None:
        block = _mesh.check_mesh(mesh).block(len(solvers), "data")
        local = None
        if mesh.index("beam") == 0:
            ins0 = solvers[0]
            g = engine.pad_grid(ins0.problem)
            ids = range(len(solvers))[block]
            u = torch.stack([instance_uniforms(seed, b, (g.Ny, g.Nx, M),
                                               ins0.dtype, ins0.device)
                             for b in ids]) if uniforms is None \
                else torch.as_tensor(uniforms)[block]
            local = multi_flagship_sample(
                solvers[block], M=M, Dmax=Dmax, tolS=tolS, tolV=tolV,
                max_sweeps=max_sweeps,
                graduate_truncation=graduate_truncation, pre_steps=pre_steps,
                pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps,
                max_scale=max_scale, zipup_rsvd=zipup_rsvd, omega=omega,
                uniforms=u, stage_times=stage_times)
        return _mesh.gather_data(local, mesh)
    check_rsvd(zipup_rsvd)
    f = fleet_tables(solvers)
    with StageClock(stage_times, f["device"]) as clock:
        ctx = _boundary_stages(
            solvers, f, clock, pre_steps=pre_steps, max_scale=max_scale,
            Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
            pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps, rsvd=zipup_rsvd,
            omega=omega)
        return multi_sample([ctx], M=M, Dmax=Dmax, seed=seed,
                            uniforms=uniforms, stage_times=stage_times)


def flagship_sample(ins, M=2 ** 10, Dmax=32, tolS=1e-15, tolV=1e-10,
                    max_sweeps=20, graduate_truncation=True, seed=0,
                    pre_steps=1, pre_Dmax=8, pre_sweeps=20, max_scale=1024,
                    zipup_rsvd=None, omega=None, uniforms=None,
                    stage_times=None):
    """Gibbs sampling on ``ins.device`` in ``ins.dtype``: balancing
    preconditioner ladder, boundary build and the M-walker sampling pass
    (tnax's ``flagship_sample``, with its arguments). It is the fleet of
    one: :func:`multi_flagship_sample` with B = 1, so ``seed`` gives the
    uniforms of instance 0 of a fleet, and ``uniforms`` (Ny, Nx, M)
    injects them. Returns dict(states, energy, negative_probability).
    """
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms)[None]
    return multi_flagship_sample(
        [ins], M=M, Dmax=Dmax, tolS=tolS, tolV=tolV, max_sweeps=max_sweeps,
        graduate_truncation=graduate_truncation, seed=seed,
        pre_steps=pre_steps, pre_Dmax=pre_Dmax, pre_sweeps=pre_sweeps,
        max_scale=max_scale, zipup_rsvd=zipup_rsvd, omega=omega,
        uniforms=uniforms, stage_times=stage_times)[0]


def exact_energies(ctx, states):
    """Exact float64 energies of the block-state configurations ``states``
    (M, Ny*Nx) of the one instance of ``ctx``, in the current rotation's
    snake order (tnax's ``exact_energies``)."""
    _one(ctx, "exact_energies")
    return exact_energies_problem(ctx.problems[0], states)


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


# ---------------------------------------------------------------------------
# the device mesh: 'data' over instances, 'beam' over a search's branches
# ---------------------------------------------------------------------------

make_mesh = _mesh.make_mesh


def _check_mesh_device(device, mesh):
    def index(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return d.type, torch.cuda.current_device()
        return d.type, d.index if d.type == "cuda" else None
    if index(device) != index(mesh.device):
        raise ValueError(f"this rank's instances are on {device}, its mesh "
                         f"device is {mesh.device}")


def beam_boundary(ctx, axis, Dmax, tolS, tolV, max_sweeps,
                  graduate_truncation=True, rsvd=None, omega=None):
    """The boundary stack rhoT of ``ctx`` at ``Dmax``, the same on every
    rank of the beam ``axis``: built (or kept, see
    ``ContractionContext.build_boundary``) on the axis's first rank and
    broadcast to the others, which build nothing (redundant QR and SVD
    builds need not agree to the bit)."""
    if axis.index == 0:
        rhoT = ctx.build_boundary(Dmax, tolS, tolV, max_sweeps,
                                  graduate_truncation, rsvd=rsvd,
                                  omega=omega)
    else:
        rhoT = torch.empty((ctx.B, ctx.Ny + 1, ctx.Nx, Dmax, ctx.lv, Dmax),
                           dtype=ctx.dtype, device=ctx.device)
    return _mesh.broadcast(rhoT, axis)


def sharded_row_step(mesh, *, M, Nx, bits, min_dEng, log2_cutoff, cand=None,
                     select="topk"):
    """The row step over a ('data', 'beam') mesh (tnax's
    ``sharded_row_step``): a function ``step(beam, row) -> (beam', aux)``
    of this rank's shards, as tnax's ``shard_map`` body sees them. The
    beam arrays are this rank's block of the instances and of the M
    branches, (B/n_data, M/n_beam, ...), with aidx global row-start ids;
    the row arrays (:func:`row_step`'s) are its block of the instances,
    with RRs over all M branches. aux (B/n_data,) is reduced over 'beam'.
    ValueError unless M tiles the beam axis."""
    _check_select(select)
    axis = _mesh.check_mesh(mesh).axis("beam")
    axis.block(M)

    def step(beam, row):
        return row_step(beam, row, M=M, Nx=Nx, bits=bits, min_dEng=min_dEng,
                        log2_cutoff=log2_cutoff, cand=cand, axis=axis)
    return step


def sharded_row_records(mesh, *, M, C, Nx, bits, min_dEng, log2_cutoff,
                        P=None):
    """:func:`row_records_prog` over the mesh's 'beam' axis (tnax's
    ``sharded_row_records``): a function ``step(beam, row, AT_row,
    Wt_row, rec=None) -> (beam', rec)`` of this rank's block of the M
    branches (vind, Eng, prob, valid (B, M/n_beam, ...)); the records are
    the same on every rank, so the host replay is the single card's.
    ValueError unless M and C tile the beam axis."""
    axis = _mesh.check_mesh(mesh).axis("beam")
    axis.block(M)
    axis.block(C)

    def step(beam, row, AT_row, Wt_row, rec=None):
        return row_records_prog(beam, row, AT_row, Wt_row, M=M, C=C, Nx=Nx,
                                bits=bits, min_dEng=min_dEng,
                                log2_cutoff=log2_cutoff, P=P, rec=rec,
                                axis=axis)
    return step


def sharded_search_gs(ctxs, mesh, M=2 ** 10, relative_P_cutoff=1e-6,
                      min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                      max_sweeps=20, graduate_truncation=True,
                      cand_factor=8, select="topk", zipup_rsvd=None,
                      omega=None, stage_times=None):
    """Ground-state search over a ('data', 'beam') mesh (tnax's
    ``sharded_search_gs``, with its arguments): the instances shard over
    'data', and within each instance the M branches over 'beam', with the
    pmax, psum, pmin and gathers of :func:`row_step` at every site.

    Every rank passes all the contexts (on its mesh device) and returns
    the list of every instance's result dict (:func:`multi_search_gs`'s
    keys). len(ctxs) must tile the data axis and M the beam axis
    (ValueError). Each data group's stacks are built on its first beam
    rank and broadcast (:func:`beam_boundary`; ``zipup_rsvd`` and
    ``omega`` set the zip-up). ``stage_times``, if a dict, receives the
    seconds of this rank's boundary and search.
    """
    ctxs = list(ctxs)
    if not ctxs:
        raise ValueError("need at least one context")
    block = _mesh.check_mesh(mesh).block(len(ctxs), "data")
    axis = mesh.axis("beam")
    axis.block(M)
    _check_select(select)
    check_rsvd(zipup_rsvd)
    ctx = ContractionContext.stack(ctxs[block])
    _check_mesh_device(ctx.device, mesh)
    with StageClock(stage_times, ctx.device) as clock:
        rhoT = beam_boundary(ctx, axis, Dmax, tolS, tolV, max_sweeps,
                             graduate_truncation, rsvd=zipup_rsvd, omega=omega)
        clock.lap("boundary")
        bits = max(1, int(np.ceil(np.log2(max(ctx.lh, ctx.lv)))))
        log2_cutoff = float(np.log2(relative_P_cutoff)) \
            if relative_P_cutoff > 0 else NEG
        cand = None if cand_factor is None else int(cand_factor) * M
        beam0 = _initial_beam(ctx.B, M, Dmax, ctx.Nx, ctx.Ny, ctx.dtype,
                              ctx.device)
        beam0 = {k: v[:, axis.block(M)] for k, v in beam0.items()}
        beam, aux = full_search_scan(beam0, search_inputs(ctx), rhoT, ctx.Wt,
                                     M=M, Nx=ctx.Nx, bits=bits,
                                     min_dEng=min_dEng,
                                     log2_cutoff=log2_cutoff, cand=cand,
                                     axis=axis)
        clock.lap("search")
    beam = {k: _mesh.all_gather(beam[k], axis, dim=1)
            for k in ("valid", "Eng", "prob", "deg", "states")}
    local = _assemble_batched_results(beam, aux) if axis.index == 0 else None
    return _mesh.gather_data(local, mesh)
