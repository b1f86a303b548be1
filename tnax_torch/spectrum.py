"""Low-energy spectrum: the host-exact search, the device decision
records and their host replay, and the droplet (excitation) store.

Counterpart of ``tnax/spectrum.py``. Whenever
two branches with the same boundary-index vector merge in the beam
search, the losing branch differs from the winner by a localized cluster
of flipped spins, a droplet; recording droplets hierarchically
reconstructs the low-energy spectrum from one search. The host path
(:func:`search_spectrum`) is the host-exact ground-state search's site
loop (``search.HostSites``, kernel K3 on CUDA) with droplets recorded at
every merge. The device path runs
each lattice row as ``parallel.row_records_prog``, which makes every beam
decision and records it; each row's records leave the device in one copy
into pinned memory while the host replays earlier rows: exact float64
energies, states, degeneracies and the droplet trees. Three encodings of
droplet independence, as the reference (`tnac4o/tnac4o.py:652-725`):
1 snake order, 2 adjacency graph, 3 adjacency graph flattened to one
layer.

The droplet store is host code in tnax too, and is a NumPy copy of it
(tnax's module imports jax, so it cannot be imported here):
``d`` (shape dictionary), ``invd`` (semi-hash inverse), ``el``
(per-branch excitation trees), ``free_d`` (next free key), ``adj``
(adjacency), ``xor2ind`` (cluster XOR -> flipped spin ids). Tree nodes are
``((dEng, key[, first, last, dP]), (children...))`` tuples, the reference's
format. Its scalar hot loops run in C (``tnax_torch.native``) unless the
caller passes ``native=False``, which selects their NumPy versions; an
RMF lattice's droplets are sets of sites, tested on the grid in NumPy.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import scipy.sparse
import torch

from . import native as _native
from . import parallel as par
from .config import StageClock
from .parallel import NEG
from .problems import block_bits
from .search import (ContractionContext, HostSites, SearchResult,
                     expand_candidates, merge_by_vind, top_m)

logger = logging.getLogger("tnax_torch")


def _lib(ins):
    """The native droplet library, or None where the caller chose the
    NumPy versions (``native=False``)."""
    return _native.lib() if getattr(ins, "droplet_native", True) else None


# ---------------------------------------------------------------------------
# droplet store primitives (reference tnac4o/tnac4o.py:2012-2423)
# ---------------------------------------------------------------------------

def exc_init(ins):
    """Reference `_exc_initialise` (`tnac4o/tnac4o.py:2012-2019`)."""
    ins.d = {}
    ins.invd = {}
    ins.el = [[]]
    ins.free_d = 0
    ins._shape_masks = {}
    ins._keyl = {}


def _semihash(dpos, dstate):
    """Cheap shape fingerprint (reference `_exc_get_sh`)."""
    return (dpos[0], dstate[0], dpos[-1], dstate[-1])


def exc_register(ins, dpos, dstate):
    """Deduplicating insert into the shape dictionary; returns the key
    (reference `_exc_add_to_d`). Dedup goes through an exact byte-key dict
    (``_keyl``); ``invd`` is kept in the reference's format."""
    kb = (dpos.tobytes(), dstate.tobytes())
    hit = ins._keyl.get(kb)
    if hit is not None:
        return hit
    sh = _semihash(dpos, dstate)
    key = ins.free_d
    ins.invd.setdefault(sh, []).append(key)
    ins.d[key] = (dpos, dstate)
    ins._keyl[kb] = key
    ins.free_d += 1
    return key


def exc_prune_energy(exc, max_dE):
    """Drop sub-excitations beyond the remaining energy budget,
    recursively (reference `_exc_cut_energy`)."""
    kept = tuple(exc_prune_energy(se, max_dE - se[0][0])
                 for se in exc[1] if se[0][0] <= max_dE)
    return (exc[0], kept)


def exc_gc(ins):
    """Drop the shapes no tree uses (reference `_exc_clear_d`). Branches
    share subtrees, so the walk visits each shared node once."""
    live = set()
    seen = set()

    def walk(tree):
        for exc in tree:
            if id(exc) in seen:
                continue
            seen.add(id(exc))
            live.add(exc[0][1])
            walk(exc[1])

    for bel in ins.el:
        if id(bel) not in seen:
            seen.add(id(bel))
            walk(bel)
    nd, ninvd, nkeyl = {}, {}, {}
    for k in live:
        dpos, dstate = ins.d[k]
        nd[k] = (dpos, dstate)
        ninvd.setdefault(_semihash(dpos, dstate), []).append(k)
        nkeyl[(dpos.tobytes(), dstate.tobytes())] = k
    ins.d, ins.invd, ins._keyl = nd, ninvd, nkeyl


def reset_adjacency(ins, J, Nx, Ny, ind):
    """Adjacency matrix and cluster-XOR decode tables (reference
    `_reset_adj`, `tnac4o/tnac4o.py:2021-2041`), and their bitset forms
    (:func:`adjacency_tables`); for RMF only the lattice's width and
    height."""
    ins._shape_masks = {}
    if ins.mode != "Ising":
        ins.adj_Nx, ins.adj_Ny = Nx, Ny
        return
    adj = (scipy.sparse.triu(J, 1) != 0)
    ins.adj = (adj + adj.T).toarray()
    ins.xor2ind = []
    for ny in range(Ny):
        for nx in range(Nx):
            act = np.asarray(ind[ny][nx])
            bits = block_bits(len(act)).astype(bool)
            ins.xor2ind.append([act[bits[i]] for i in range(2 ** len(act))])
    adjacency_tables(ins)


def adjacency_tables(ins):
    """Bitset views of ``ins.adj`` and a CSR view of ``ins.xor2ind``: uint64
    rows of the adjacency (``adj_bits``) and of the unit rows
    (``unit_bits``), the adjacency rows as Python ints (``adj_ints``; the
    droplet-overlap test is one int AND), and (starts, values, site_base,
    max length) of the xor2ind tables for the native spin expansion."""
    ins._shape_masks = {}
    L = ins.adj.shape[0]
    W = (L + 63) // 64
    padded = np.zeros((L, W * 64), dtype=bool)
    padded[:, :L] = ins.adj
    # little-endian bit order: spin c <-> bit (c & 63) of word (c >> 6),
    # shared with the native code (tnax_torch/native/droplets.c)
    ins.adj_bits = np.packbits(padded, axis=-1, bitorder="little") \
        .view(np.uint64).reshape(L, W)
    eye = np.zeros((L, W * 64), dtype=bool)
    eye[np.arange(L), np.arange(L)] = True
    ins.unit_bits = np.packbits(eye, axis=-1, bitorder="little") \
        .view(np.uint64).reshape(L, W)
    ins.adj_ints = [int.from_bytes(ins.adj_bits[i].tobytes(), "little")
                    for i in range(L)]
    # slot = site_base[p] + s -> values[starts[slot]:starts[slot+1]]
    site_base = np.zeros(len(ins.xor2ind) + 1, np.int64)
    for p, tab in enumerate(ins.xor2ind):
        site_base[p + 1] = site_base[p] + len(tab)
    lens = [len(v) for tab in ins.xor2ind for v in tab]
    starts = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    values = np.concatenate(
        [np.asarray(v, np.int64) for tab in ins.xor2ind for v in tab]
        or [np.zeros(0, np.int64)])
    ins._xor_csr = (np.ascontiguousarray(starts),
                    np.ascontiguousarray(values),
                    np.ascontiguousarray(site_base[:-1]),
                    int(max(lens) if lens else 0))


def reset_adjacency_from_saved(ins, adj):
    """Rebuild the adjacency helpers after ``load`` (reference `load`,
    `tnac4o/tnac4o.py:60-72`)."""
    if ins.mode == "Ising":
        reset_adjacency(ins, adj, ins.Nx_model, ins.Ny_model, ins.ind0)
    else:
        ins.adj_Nx, ins.adj_Ny = ins.Nx_model, ins.Ny_model


def _flipped_spins(ins, dpos, dstate):
    """Global ids of flipped spins (reference `_exc_xor2ind`)."""
    L = _lib(ins)
    if L is not None:
        starts, values, site_base, maxlen = ins._xor_csr
        dpos = np.ascontiguousarray(dpos, np.int64)
        dstate = np.ascontiguousarray(dstate, np.int64)
        n = len(dpos)
        out = np.empty(n * maxlen, np.int64)
        k = L.tnax_spins(starts.ctypes.data, values.ctypes.data,
                         site_base.ctypes.data, dpos.ctypes.data,
                         dstate.ctypes.data, n, out.ctypes.data)
        return out[:k]
    return np.hstack([ins.xor2ind[p][s] for p, s in zip(dpos, dstate)]) \
        .astype(np.int64, copy=False)


def _elem_batch(ins, dpos_flat, dstate_flat, bounds):
    """Connectivity flags of a whole site's losers in one native call
    (:func:`exc_elementary` for each); None with the NumPy versions and
    for RMF."""
    L = _lib(ins)
    if L is None or ins.mode != "Ising":
        return None
    starts, values, site_base, maxlen = ins._xor_csr
    n = len(bounds) - 1
    if n == 0:
        return np.zeros(0, bool)
    dpos_flat = np.ascontiguousarray(dpos_flat, np.int64)
    dstate_flat = np.ascontiguousarray(dstate_flat, np.int64)
    bounds = np.ascontiguousarray(bounds, np.int64)
    max_spins = int(np.max(bounds[1:] - bounds[:-1])) * max(maxlen, 1)
    out = np.empty(n, np.int64)
    _native.check(L.tnax_elem_batch(
        starts.ctypes.data, values.ctypes.data, site_base.ctypes.data,
        ins.adj_bits.ctypes.data, ins.adj_bits.shape[1],
        dpos_flat.ctypes.data, dstate_flat.ctypes.data, bounds.ctypes.data,
        n, max_spins, out.ctypes.data), "tnax_elem_batch")
    return out.astype(bool)


def exc_elementary(ins, dpos, dstate):
    """Is the droplet single-connected? (reference `_exc_elementary`,
    `tnac4o/tnac4o.py:2087-2114`): Ising as a breadth-first search on the
    adjacency bitsets, RMF on the lattice's nearest neighbours."""
    if ins.mode != "Ising":
        grp, rest = dpos[:1], dpos[1:]
        while grp.size and rest.size:
            gx, gy = grp % ins.adj_Nx, grp // ins.adj_Nx
            rx, ry = rest % ins.adj_Nx, rest // ins.adj_Nx
            dist = np.abs(gx[:, None] - rx[None, :]) + \
                np.abs(gy[:, None] - ry[None, :])
            hit = np.any(dist == 1, axis=0)
            grp, rest = rest[hit], rest[~hit]
        return rest.size == 0
    spins = _flipped_spins(ins, dpos, dstate)
    if spins.size <= 1:
        return True
    L = _lib(ins)
    if L is not None:
        return bool(_native.check(
            L.tnax_elementary(ins.adj_bits, ins.adj_bits.shape[1], spins,
                              len(spins)), "tnax_elementary"))
    rest = np.bitwise_or.reduce(ins.unit_bits[spins[1:]], axis=0)
    frontier = spins[:1]
    while frontier.size and rest.any():
        nb = np.bitwise_or.reduce(ins.adj_bits[frontier], axis=0)
        new = nb & rest
        rest &= ~new
        frontier = np.flatnonzero(
            np.unpackbits(new.view(np.uint8), bitorder="little"))
    return not rest.any()


def _shape_of(ins, e):
    return ins.d[e] if isinstance(e, (int, np.integer)) else e


def _shape_masks(ins, e):
    """(spin bitset, adjacency-neighbourhood bitset) of a droplet as
    Python ints, cached by dictionary key (keys are never reused)."""
    key = e if isinstance(e, (int, np.integer)) else None
    if key is not None:
        hit = ins._shape_masks.get(key)
        if hit is not None:
            return hit
    spins = _flipped_spins(ins, *(ins.d[key] if key is not None else e))
    sm = nm = 0
    adj_ints = ins.adj_ints
    for s in spins.tolist():
        sm |= 1 << s
        nm |= adj_ints[s]
    masks = (sm, nm)
    if key is not None:
        ins._shape_masks[key] = masks
    return masks


def exc_overlap(ins, e1, e2):
    """Do two droplets interact? (reference `_exc_overlap`,
    `tnac4o/tnac4o.py:2116-2141`): Ising as ``neighbourhood(e1) &
    spins(e2)`` on the cached bitsets, RMF as two sites at most one step
    apart."""
    if ins.mode == "Ising":
        return (_shape_masks(ins, e1)[1] & _shape_masks(ins, e2)[0]) != 0
    p1, p2 = _shape_of(ins, e1)[0], _shape_of(ins, e2)[0]
    x1, y1 = p1 % ins.adj_Nx, p1 // ins.adj_Nx
    x2, y2 = p2 % ins.adj_Nx, p2 // ins.adj_Nx
    dist = np.abs(x1[:, None] - x2[None, :]) \
        + np.abs(y1[:, None] - y2[None, :])
    return bool(np.any(dist <= 1))


def exc_hd(ins, dstate):
    """Droplet size used by lim_hd (reference `_exc_hd`): Ising its
    number of flipped blocks, RMF the set bits of its XORs."""
    if ins.mode == "Ising":
        return len(dstate)
    return int(sum(bin(int(s)).count("1") for s in dstate))


def exc_hd_pair(ins, e1, e2):
    """Hamming distance between two droplets (reference `_exc_hd_comp`)."""
    (p1, s1), (p2, s2) = _shape_of(ins, e1), _shape_of(ins, e2)
    ising = ins.mode == "Ising"
    L = _lib(ins)
    if L is not None:
        f = L.tnax_hd_pair_ising if ising else L.tnax_hd_pair_rmf
        return int(f(np.ascontiguousarray(p1, np.int64),
                     np.ascontiguousarray(s1, np.int64), len(p1),
                     np.ascontiguousarray(p2, np.int64),
                     np.ascontiguousarray(s2, np.int64), len(p2)))
    l1, l2 = len(p1), len(p2)
    n1 = n2 = hd = 0
    if not ising:
        # RMF: the positions at which the shapes differ
        while n1 < l1 and n2 < l2:
            if p1[n1] == p2[n2]:
                hd += int(s1[n1] != s2[n2])
                n1 += 1
                n2 += 1
            elif p1[n1] < p2[n2]:
                n1 += 1
                hd += 1
            else:
                n2 += 1
                hd += 1
        return hd + (l1 - n1) + (l2 - n2)
    while n1 < l1 and n2 < l2:
        if p1[n1] == p2[n2]:
            hd += bin(int(s1[n1]) ^ int(s2[n2])).count("1")
            n1 += 1
            n2 += 1
        elif p1[n1] < p2[n2]:
            hd += bin(int(s1[n1])).count("1")
            n1 += 1
        else:
            hd += bin(int(s2[n2])).count("1")
            n2 += 1
    hd += sum(bin(int(s)).count("1") for s in s1[n1:])
    hd += sum(bin(int(s)).count("1") for s in s2[n2:])
    return hd


def exc_merge_shapes(ins, e1, e2):
    """XOR-combine two droplets into one sorted shape (reference
    `_exc_merge`)."""
    (p1, s1), (p2, s2) = _shape_of(ins, e1), _shape_of(ins, e2)
    L = _lib(ins)
    if L is not None:
        n1, n2 = len(p1), len(p2)
        pos = np.empty(n1 + n2, np.int64)
        st = np.empty(n1 + n2, np.int64)
        k = L.tnax_merge_shapes(
            np.ascontiguousarray(p1, np.int64),
            np.ascontiguousarray(s1, np.int64), n1,
            np.ascontiguousarray(p2, np.int64),
            np.ascontiguousarray(s2, np.int64), n2, pos, st)
        return pos[:k], st[:k]
    pos, st = [], []
    n1 = n2 = 0
    while n1 < len(p1) and n2 < len(p2):
        if p1[n1] == p2[n2]:
            x = int(s1[n1]) ^ int(s2[n2])
            if x:
                pos.append(p1[n1])
                st.append(x)
            n1 += 1
            n2 += 1
        elif p1[n1] < p2[n2]:
            pos.append(p1[n1])
            st.append(s1[n1])
            n1 += 1
        else:
            pos.append(p2[n2])
            st.append(s2[n2])
            n2 += 1
    pos.extend(p1[n1:])
    st.extend(s1[n1:])
    pos.extend(p2[n2:])
    st.extend(s2[n2:])
    return np.asarray(pos, dtype=np.int64), np.asarray(st, dtype=np.int64)


# ---------------------------------------------------------------------------
# unpacking the trees into excitation energies and flip lists
# ---------------------------------------------------------------------------

def unpack_v1(ins, el, max_dEng=0.0, max_states=np.inf):
    """Snake-order unpack (reference `_exc_unpack_v1`)."""
    Eng = [0.0]
    flip = [[]]
    root = ((0.0, 0, -1, ins.Nx_model * ins.Ny_model - 1, 1), tuple(el))
    stacks = [[root]]
    for site in range(ins.Nx_model * ins.Ny_model - 1, -1, -1):
        kk = 0
        while kk < len(Eng):
            for child in stacks[kk][-1][1]:
                last = child[0][3]
                if last == site and Eng[kk] + child[0][0] <= max_dEng:
                    Eng.append(Eng[kk] + child[0][0])
                    flip.append(flip[kk] + [child[0][1]])
                    stacks.append(stacks[kk] + [child])
                elif last > site:
                    break
            kk += 1
        if len(Eng) > max_states:
            keep = np.array(Eng).argpartition(max_states)[:max_states]
            Eng = [Eng[i] for i in keep]
            flip = [flip[i] for i in keep]
            stacks = [stacks[i] for i in keep]
        for kk in range(len(Eng)):
            while stacks[kk][-1][0][2] >= site:
                stacks[kk].pop()
    return np.array(Eng), flip


def unpack_v2(ins, excs, max_dEng=0.0, max_states=np.inf, one_layer=False):
    """Graph-independence unpack (reference `_exc_unpack_v2`,
    `tnac4o/tnac4o.py:2337-2377`): for Ising in C, or with
    ``native=False`` the same traversal in Python on cached masks; for
    RMF the reference's traversal with :func:`exc_overlap`."""
    if ins.mode == "Ising":
        if _lib(ins) is not None:
            return _unpack_v2_native(ins, excs, max_dEng, max_states,
                                     one_layer)
        return _unpack_v2_ising(ins, excs, max_dEng, max_states, one_layer)
    Eng = [0.0]
    pending = [list(excs)]
    flip = [[]]
    progressed = True
    while progressed:
        progressed = False
        kk = 0
        while kk < len(Eng):
            if pending[kk]:
                exc = pending[kk].pop()
                if Eng[kk] + exc[0][0] <= max_dEng:
                    Eng.append(Eng[kk] + exc[0][0])
                    flip.append(flip[kk] + [exc[0][1]])
                    rest = [x for x in pending[kk]
                            if not exc_overlap(ins, x[0][1], exc[0][1])]
                    pending.append(rest)
                    if not one_layer:
                        rest.extend(list(exc[1]))
                    progressed = True
            kk += 1
        if len(Eng) > max_states:
            keep = np.array(Eng).argpartition(max_states)[:max_states]
            Eng = [Eng[i] for i in keep]
            flip = [flip[i] for i in keep]
            pending = [pending[i] for i in keep]
    return np.array(Eng), flip


def _unpack_v2_native(ins, excs, max_dEng, max_states, one_layer):
    """``tnax_unpack_v2`` (native/droplets.c): the same traversal on a
    flattened tree, flip lists as shared chains, pending lists as int32
    arrays, the overlap filter as word ANDs."""
    L = _lib(ins)
    # flatten breadth-first so each node's children are contiguous
    items = list(excs)
    n_root = len(items)
    dE, keys, cs, cc = [], [], [], []
    i = 0
    while i < len(items):
        exc = items[i]
        dE.append(exc[0][0])
        keys.append(exc[0][1])
        ch = () if one_layer else exc[1]
        cs.append(len(items))
        cc.append(len(ch))
        items.extend(ch)
        i += 1
    n = len(items)
    W = ins.adj_bits.shape[1]
    if n == 0:
        return np.zeros(1), [[]]
    dE = np.asarray(dE, np.float64)
    keys_a = np.asarray(keys, np.int64)
    cs = np.asarray(cs, np.int64)
    cc = np.asarray(cc, np.int64)
    # the masks the call reads through raw pointers, held by these names
    # for the length of the call
    sm = np.empty((n, W), np.uint64)
    nm = np.empty((n, W), np.uint64)
    nbytes = W * 8
    word_cache = {}
    for t, k in enumerate(keys):
        hit = word_cache.get(k)
        if hit is None:
            s_int, n_int = _shape_masks(ins, k)
            hit = (np.frombuffer(s_int.to_bytes(nbytes, "little"),
                                 np.uint64),
                   np.frombuffer(n_int.to_bytes(nbytes, "little"),
                                 np.uint64))
            word_cache[k] = hit
        sm[t], nm[t] = hit
    ms = (2 ** 62) if max_states is None or np.isinf(max_states) \
        else int(max_states)
    n_out = _native.check(L.tnax_unpack_v2(
        dE.ctypes.data, keys_a.ctypes.data, cs.ctypes.data, cc.ctypes.data,
        sm.ctypes.data, nm.ctypes.data, W, n, n_root, float(max_dEng), ms,
        int(bool(one_layer))), "tnax_unpack_v2")
    total = L.tnax_unpack_flip_total()
    Eng = np.empty(n_out, np.float64)
    off = np.empty(n_out + 1, np.int64)
    fk = np.empty(max(total, 1), np.int64)
    L.tnax_unpack_fetch(Eng.ctypes.data, off.ctypes.data, fk.ctypes.data)
    flip = [fk[off[i]:off[i + 1]].tolist() for i in range(n_out)]
    return Eng, flip


def _unpack_v2_ising(ins, excs, max_dEng, max_states, one_layer):
    """The NumPy version of :func:`unpack_v2`: the reference's traversal,
    the overlap filter inlined on cached bitset masks (pending entries
    carry their spin mask, so each accept filters with one int AND per
    entry)."""
    def wrap(nodes):
        out = []
        for x in nodes:
            m = masks.get(x[0][1])
            if m is None:
                m = _shape_masks(ins, x[0][1])
            out.append((m[0], x))
        return out

    masks = ins._shape_masks
    Eng = [0.0]
    pending = [wrap(excs)]
    flip = [[]]
    progressed = True
    while progressed:
        progressed = False
        kk = 0
        while kk < len(Eng):
            if pending[kk]:
                _, exc = pending[kk].pop()
                if Eng[kk] + exc[0][0] <= max_dEng:
                    Eng.append(Eng[kk] + exc[0][0])
                    flip.append(flip[kk] + [exc[0][1]])
                    nm = _shape_masks(ins, exc[0][1])[1]
                    rest = [x for x in pending[kk] if not (nm & x[0])]
                    pending.append(rest)
                    if not one_layer:
                        rest.extend(wrap(exc[1]))
                    progressed = True
            kk += 1
        if len(Eng) > max_states:
            keep = np.array(Eng).argpartition(max_states)[:max_states]
            Eng = [Eng[i] for i in keep]
            flip = [flip[i] for i in keep]
            pending = [pending[i] for i in keep]
    return np.array(Eng), flip


def unpack(ins, max_dEng=0.0, max_states=np.inf):
    if ins.excitations_encoding == 1:
        return unpack_v1(ins, ins.el, max_dEng, max_states)
    if ins.excitations_encoding == 2:
        return unpack_v2(ins, ins.el, max_dEng, max_states)
    return unpack_v2(ins, ins.el, max_dEng, max_states, one_layer=True)


def decode_low_energy_states(ins, max_dEng=0.0, max_states=1024):
    """Expand the droplet tree into explicit states (reference
    `decode_low_energy_states`, `tnac4o/tnac4o.py:1360-1389`): sets
    ``ins.energy`` and ``ins.states`` sorted by energy, returns the
    lowest excitation energy."""
    Eng, flip = unpack(ins, max_dEng=max_dEng, max_states=max_states)
    gs = ins.states[0]
    order = Eng.argsort()
    Eng = Eng[order]
    nst = min(max_states, len(Eng))
    states = np.zeros((nst, len(gs)), dtype=ins.states.dtype)
    for ii in range(nst):
        st = gs.copy()
        for key in flip[order[ii]]:
            dpos, dstate = ins.d[key]
            st[dpos] = np.bitwise_xor(st[dpos], dstate)
        states[ii] = st
    ins.energy = Eng + ins.energy[0]
    ins.states = states
    return Eng[0]


def excitations_to_list(el):
    """Excitation tree -> nested lists (reference
    `_exc_excitations_to_list`)."""
    return [[exc[0], excitations_to_list(exc[1])] for exc in el]


def exc_export_shapes(ins, el=None, ind=-1, d=None):
    """RMF droplet shapes as {index: [dEng, [[x, y], ...]]} (reference
    `_exc_export_shapes`, `tnac4o/tnac4o.py:2390-2404`)."""
    if ins.mode != "RMF":
        raise ValueError("exc_export_shapes is defined for RMF mode")
    el = ins.el if el is None else el
    d = {} if d is None else d
    for exc in el:
        ind += 1
        dpos = ins.d[exc[0][1]][0]
        nx = np.mod(dpos, ins.adj_Nx)
        ny = dpos // ins.adj_Nx
        d[ind] = [exc[0][0], [[int(x), int(y)] for x, y in zip(nx, ny)]]
        if exc[1]:
            d = exc_export_shapes(ins, exc[1], ind, d)
    return d


def exc_show_properties(ins):
    """Reference `_exc_show_properties` (`tnac4o/tnac4o.py:2043-2049`)."""
    print("Excitation encoding  :", ins.excitations_encoding)
    print("Size of dictionary   :", len(ins.d))
    print("Exc in first layer   :", len(ins.el))


def exc_print(ins, el=None, layer=1):
    """Display the excitation tree (reference `exc_print`,
    `tnac4o/tnac4o.py:2406-2423`)."""
    el = ins.el if el is None else el
    for exc in el:
        dpos, dstate = ins.d[exc[0][1]]
        print((3 * layer - 3) * " " + "|- %0.4f " % exc[0][0] + " : "
              + " ".join(map(str, dpos)) + " | " + " ".join(map(str, dstate)))
        exc_print(ins, exc[1], layer + 1)


# ---------------------------------------------------------------------------
# droplet recording at a merge
# ---------------------------------------------------------------------------

def record_losers(ins, ee, bel, losers, ny, nx, Nx, max_dEng, lim_hd):
    """Append droplet records for the losing members of one merge group.

    ``bel`` is (a copy of) the group representative's excitation tree and
    is mutated in place. ``losers`` yields one tuple per
    non-representative member: (cdE, dpos, dstate, dP, pel[, elem]) — the
    energy gap to the representative, positions and values of the XOR of
    block states with it, the log2-prob gap to the merged branch, the
    loser's own excitation tree, and optionally its connectivity flag.
    The per-encoding bodies of the reference (`tnac4o/tnac4o.py:855-874`,
    `:1079-1087`, `:1271-1282`).
    """
    if ee == 3:
        fresh = []
    for rec in losers:
        cdE, dpos, dstate, dP, pel = rec[:5]
        elem = rec[5] if len(rec) > 5 else None
        if cdE > max_dEng:
            continue
        if ee == 1:
            if lim_hd > 1 and exc_hd(ins, dstate) < lim_hd:
                continue
            dfirst = int(dpos[0])
            dlast = Nx * ny + nx
            di = exc_register(ins, dpos, dstate)
            sel = [exc_prune_energy(sne, max_dEng - (sne[0][0] + cdE))
                   for sne in pel
                   if sne[0][3] >= dfirst and sne[0][0] + cdE <= max_dEng]
            bel.append(((cdE, di, dfirst, dlast, dP), tuple(sel)))
        elif ee == 2:
            if (lim_hd > 1 and exc_hd(ins, dstate) < lim_hd) or \
                    not (exc_elementary(ins, dpos, dstate)
                         if elem is None else elem):
                continue
            di = exc_register(ins, dpos, dstate)
            lim = max_dEng - cdE
            if ins.mode == "Ising":
                # exc_overlap inlined, the new droplet's neighbourhood
                # mask hoisted out of the walk over the parent's tree
                nm = _shape_masks(ins, di)[1]
                masks = ins._shape_masks
                sel = []
                for sne in pel:
                    h0 = sne[0]
                    if h0[0] > lim:
                        continue
                    m2 = masks.get(h0[1])
                    if m2 is None:
                        m2 = _shape_masks(ins, h0[1])
                    if nm & m2[0]:
                        sel.append(exc_prune_energy(sne, lim - h0[0]))
            else:
                sel = [exc_prune_energy(sne, lim - sne[0][0])
                       for sne in pel
                       if sne[0][0] <= lim
                       and exc_overlap(ins, di, sne[0][1])]
            bel.append(((cdE, di), tuple(sel)))
        else:  # ee == 3: flatten the hierarchy to one layer
            nsel = [sne for sne in pel
                    if sne[0][0] + cdE <= max_dEng
                    and exc_overlap(ins, (dpos, dstate), sne[0][1])]
            sEng, sflip = unpack_v2(ins, nsel, max_dEng - cdE,
                                    one_layer=True)
            for nn in range(len(sEng)):
                sub = (dpos, dstate)
                for sdi in sflip[nn]:
                    sub = exc_merge_shapes(ins, sub, sdi)
                if (lim_hd <= 1 or exc_hd(ins, sub[1]) >= lim_hd) \
                        and exc_elementary(ins, *sub):
                    sdi = exc_register(ins, *sub)
                    fresh.append(((sEng[nn] + cdE, sdi), ()))
    if ee == 3:
        bel.extend(sorted(fresh, key=lambda x: x[0][0]))


def _finalize_spectrum(ins, ee, lim_hd):
    """Post-search droplet cleanup: ee=3 greedy Hamming dedup (reference
    `tnac4o/tnac4o.py:1323-1338`), shape positions back to the unrotated
    cluster order (`:907-914`), adjacency reset."""
    if ee == 3:
        bel = sorted(ins.el[0], key=lambda x: x[0][0])
        if lim_hd > 1:
            distinct = []
            for x in bel:
                if all(exc_hd_pair(ins, x[0][1], y[0][1]) >= lim_hd
                       for y in distinct):
                    distinct.append(x)
            ins.el[0] = distinct
        else:
            ins.el[0] = bel
        exc_gc(ins)
    ins.el = ins.el[0]
    for key, (dpos, dstate) in ins.d.items():
        dpos = ins.order_i[dpos]
        srt = dpos.argsort()
        ins.d[key] = (dpos[srt], dstate[srt])
    if ee > 1:
        ising = ins.mode == "Ising"
        reset_adjacency(ins, ins.J0 if ising else None, ins.Nx_model,
                        ins.Ny_model, ins.ind0 if ising else None)


def _reset_problem_adjacency(ins, Nx, Ny):
    """The adjacency of the solver's current (rotated, noisy) problem, as
    the searches record droplets in it."""
    ising = ins.mode == "Ising"
    reset_adjacency(ins, ins.problem.J if ising else None, Nx, Ny,
                    ins.problem.ind if ising else None)


# ---------------------------------------------------------------------------
# the host-exact spectrum search
# ---------------------------------------------------------------------------

def search_spectrum(ins, ctx, excitations_encoding, M=2 ** 10,
                    relative_P_cutoff=1e-6, max_dEng=0.0, lim_hd=0,
                    min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                    max_sweeps=20, graduate_truncation=True, zipup_rsvd=None,
                    omega=None, native=True,
                    stage_times=None) -> SearchResult:
    """Beam search with droplet recording at merges, the host-exact path
    (tnax's ``search_spectrum``; reference
    `_search_low_energy_spectrum_v{1,2,3}`, `tnac4o/tnac4o.py:727-1358`):
    the site loop of ``search.search_ground_state`` (one read of the
    device per site), every candidate of every merge in float64, and the
    losers of each kept group recorded as droplets. One loop serves the
    three encodings; only the recording differs. ``zipup_rsvd`` and
    ``omega`` set the boundary's zip-up, ``native`` the droplet store's C
    code (else its NumPy versions); ``stage_times``, if a dict, receives
    the seconds of the boundary and of the search. Returns a
    ``search.SearchResult``.
    """
    ee = excitations_encoding
    with StageClock(stage_times, ctx.device) as clock:
        t_total = time.time()
        logger.info("Preprocessing boundary MPS (D=%d) ...", Dmax)
        ctx.build_boundary(Dmax, tolS, tolV, max_sweeps, graduate_truncation,
                           rsvd=zipup_rsvd, omega=omega)
        clock.lap("boundary")
        logger.info("Elapsed: %.2f s", time.time() - t_total)

        Ny, Nx = ctx.Ny, ctx.Nx
        vind = np.zeros((1, Nx + 1), dtype=np.int32)
        states = np.zeros((1, Nx * Ny), dtype=np.int32)
        Eng = np.zeros(1)
        prob = np.zeros(1)
        deg = np.ones(1, dtype=np.int64)
        pd_max, globalmin, globalmin_core = -np.inf, 1.0, 0.0
        ins.droplet_native = native
        exc_init(ins)
        if ee > 1:
            _reset_problem_adjacency(ins, Nx, Ny)

        sites = HostSites(ctx, M, relative_P_cutoff)
        for ny in range(Ny):
            t_row = time.time()
            K = len(prob)
            RL = sites.start_row(ny, vind)
            aidx = np.arange(K, dtype=np.int32)

            for nx in range(Nx):
                n = int(ctx.nstates[0, ny, nx])
                inds, indc, probf, pd_max, minP, minP_core = expand_candidates(
                    *sites.marginals(nx, RL, aidx, vind, prob), prob, K, n,
                    ctx.Np, M, relative_P_cutoff, pd_max)
                globalmin = min(globalmin, minP)
                globalmin_core = min(globalmin_core, minP_core)
                states = states[inds]
                states[:, ny * Nx + nx] = indc
                vind = vind[inds]
                deg = deg[inds]
                aidx = aidx[inds]
                Eng = Eng[inds]
                Es, Esl, Esu = ctx.energy_tables(ny, nx)
                Eng = Eng + Es[indc] + Esl[indc, vind[:, nx]] \
                    + Esu[indc, vind[:, nx + 1]]
                vind[:, nx] = ctx.dmap[0, ny, nx][indc]
                vind[:, nx + 1] = ctx.rmap[0, ny, nx][indc]

                vindn, rep, degn, probn, gorder, starts, g = merge_by_vind(
                    vind, Eng, probf, deg, min_dEng)
                ends = np.r_[starts[1:], len(g)]
                keep, pd_max = top_m(probn, M, pd_max)

                # droplet recording: the losers of each kept merge group
                new_el = []
                for kk in keep:
                    members = gorder[starts[kk]:ends[kk]]
                    rep_kk = rep[kk]
                    E_kk = Eng[rep_kk]
                    bel = ins.el[inds[rep_kk]][:]

                    def _loser(ii):
                        dfull = np.bitwise_xor(states[rep_kk], states[ii])
                        dpos = np.flatnonzero(dfull).astype(np.int64)
                        return (Eng[ii] - E_kk, dpos,
                                dfull[dpos].astype(np.int64),
                                probf[ii] - probn[kk], ins.el[inds[ii]])
                    losers = (_loser(ii) for ii in members if ii != rep_kk)
                    record_losers(ins, ee, bel, losers, ny, nx, Nx, max_dEng,
                                  lim_hd)
                    new_el.append(bel)

                vind = vindn[keep]
                prob = probn[keep]
                deg = degn[keep]
                rk = rep[keep]
                states = states[rk]
                Eng = Eng[rk]
                parent = inds[rk].astype(np.int32)
                aidx = aidx[rk]
                ins.el = new_el
                K = len(prob)
                RL = sites.rl_update(nx, RL, parent, vind[:, nx])
                if ee < 3:
                    exc_gc(ins)
            if ee == 3:
                exc_gc(ins)
            logger.info("Row %d/%d: %d branches, %d shapes, %.2f s", ny + 1,
                        Ny, K, len(ins.d), time.time() - t_row)
            vind[:, 1:] = vind[:, :-1]
            vind[:, 0] = 0
        clock.lap("search")
    logger.info("Spectrum search total: %.2f s", time.time() - t_total)

    _finalize_spectrum(ins, ee, lim_hd)
    return SearchResult(
        energy=Eng, probability=prob, degeneracy=int(deg[0]), states=states,
        discarded_probability=float(pd_max),
        negative_probability=min(globalmin, 0.0),
        negative_probability_core=min(globalmin_core, 0.0))


# ---------------------------------------------------------------------------
# the device records and their replay
# ---------------------------------------------------------------------------

def records_select(C, M):
    """The records' candidate order: the prob-ordered top C at production
    caps, tnax's branch-major ``compact`` order at C >= 16*M
    (spectrum.py:895-901), which sets which equal-energy member represents
    a group and the replay's loser order."""
    return "compact" if C >= 16 * M else "topk"


def caps(M, Np, cand_factor, n_beam=1):
    """(C, P): the candidate cap (None: the full M*Np expansion), less
    its remainder modulo ``n_beam`` (tnax spectrum.py:1333), and the pull
    cap of the records (tnax spectrum.py:940-949): at the full expansion
    P = C, else min(C, max(16 M, ceil(C / 8)))."""
    C = int(M * Np) if cand_factor is None \
        else int(min(cand_factor * M, M * Np))
    C -= C % n_beam
    P = C if C >= M * Np else int(min(C, max(16 * M, -(-C // 8))))
    return C, P


def dispatch_records(ctx, *, M, C, P, relative_P_cutoff, min_dEng,
                     rhoT=None, axis=None):
    """Launch the records of every row of the B instances of ``ctx``
    (whose stack rhoT is built, or given as ``rhoT``) and start each
    row's copy to the host. Nothing waits: the device runs ahead while
    the host replays. On CUDA each row's buffer goes to pinned memory
    with one non-blocking copy, and an event marks its arrival. With a
    beam ``axis`` the branches shard over its ranks
    (``parallel.row_records_prog``; the candidates in the "topk" order)
    and every rank holds the same records. Returns (layout, [(host
    buffer, event or None)] per row)."""
    B, Ny, Nx = ctx.B, ctx.Ny, ctx.Nx
    rhoT = ctx.rhoT if rhoT is None else rhoT
    bits = max(1, int(np.ceil(np.log2(max(ctx.lh, ctx.lv)))))
    log2_cutoff = float(np.log2(relative_P_cutoff)) \
        if relative_P_cutoff > 0 else NEG
    dev = ctx.device
    grid_in = par.search_inputs(ctx)
    grid_in.pop("cols")
    layout = par.record_layout(B, Nx, M, P)
    select = records_select(C, M) if axis is None else "topk"
    beam = par._initial_beam(B, M, rhoT.shape[3], Nx, Ny, ctx.dtype, dev)
    beam = {k: beam[k] if axis is None else beam[k][:, axis.block(M)]
            for k in ("vind", "Eng", "prob", "valid")}
    rows = []
    for ny in range(Ny):
        buf = torch.empty(layout[0], dtype=torch.uint8, device=dev)
        row = {k: v[:, ny] for k, v in grid_in.items()}
        beam, _ = par.row_records_prog(
            beam, row, rhoT[:, ny + 1], ctx.Wt[:, ny], M=M, C=C, Nx=Nx,
            bits=bits, min_dEng=float(min_dEng), log2_cutoff=log2_cutoff,
            P=P, select=select, rec=par.record_views(buf, layout), axis=axis)
        if dev.type == "cuda":
            host = torch.empty(layout[0], dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            rows.append((host, event))
        else:
            rows.append((buf, None))
    return layout, rows


def _row_records(row, layout, b):
    """Instance b's records of one row as NumPy arrays (Nx, ...), after
    the row has arrived on the host."""
    host, event = row
    if event is not None:
        event.synchronize()
    return {k: v[b].numpy() for k, v in par.record_views(host,
                                                         layout).items()}


def _replay_records(ins, ctx, layout, rows, ee, *, b, M, C, P, max_dEng,
                    lim_hd, min_dEng):
    """Host replay of instance b's per-row decision records: exact
    float64 energies, states, degeneracies and droplet trees (tnax
    spectrum.py:985-1189). Returns a ``search.SearchResult``."""
    Ny, Nx = ctx.Ny, ctx.Nx
    dmap, rmap = ctx.dmap[b], ctx.rmap[b]
    exc_init(ins)
    ins.el = [[] for _ in range(M)]
    if ee > 1:
        _reset_problem_adjacency(ins, Nx, Ny)
    L = Nx * Ny
    Eng_h = np.zeros(M)
    states_h = np.zeros((M, L), dtype=np.int32)
    vind_h = np.zeros((M, Nx + 1), dtype=np.int32)
    deg_h = np.ones(M, dtype=np.int64)
    out_valid = np.zeros(M, bool)
    out_valid[0] = True
    out_prob = np.full(M, NEG)
    out_prob[0] = 0.0
    pd_max, globalmin, globalmin_core = -np.inf, 1.0, 0.0
    overflow, count_max = 0, 0
    negp_site = (0, 0)
    gc_watermark = 1024

    for ny in range(Ny):
        t_row = time.time()
        R = _row_records(rows[ny], layout, b)
        for nx in range(Nx):
            src, indc, slot = (R[k][nx] for k in ("src", "indc", "slot"))
            rep = R["rep"][nx]
            cprob = R["cprob"][nx].astype(np.float64)
            out_prob = R["out_prob"][nx].astype(np.float64)
            out_valid = R["out_valid"][nx]
            n_valid, count = int(R["n_valid"][nx]), int(R["count"][nx])
            disc_cut, disc_m, minP, minP_core = (
                float(R[k][nx]) for k in ("disc_cut", "disc_m", "minP",
                                          "minP_core"))
            if count > C or n_valid > P:
                overflow += 1
            count_max = max(count_max, count)
            if n_valid > P:
                # size the auto-grow retry so the grown pull cap
                # (max(16M, C'/8)) covers this site's merged candidates
                count_max = max(count_max, 4 * n_valid)
            for disc in (disc_cut, disc_m):
                if disc > NEG / 2:
                    pd_max = max(pd_max, disc)
            if minP < globalmin:
                globalmin, negp_site = minP, (ny, nx)
            globalmin_core = min(globalmin_core, minP_core)

            Es, Esl, Esu = ctx.energy_tables(ny, nx, b)
            n = len(Es)
            ic = np.minimum(indc, n - 1)    # clamp padded junk candidates
            E_cand = Eng_h[src] + Es[ic] + Esl[ic, vind_h[src, nx]] \
                + Esu[ic, vind_h[src, nx + 1]]
            col = ny * Nx + nx

            # the record's prefix is the merged candidates sorted by slot,
            # so grouping is a prefix slice
            gidx = np.arange(min(n_valid, P))
            gsl = slot[gidx]
            starts = np.flatnonzero(np.r_[True, gsl[1:] != gsl[:-1]])
            ends = np.r_[starts[1:], len(gsl)]

            # exact degeneracy (reference tnac4o/tnac4o.py:492-509)
            degn = np.zeros(M, dtype=np.int64)
            if len(gidx):
                Eo = E_cand[gidx]
                Emin_g = np.minimum.reduceat(Eo, starts)
                gpos = np.repeat(np.arange(len(starts)), ends - starts)
                near = (Eo - Emin_g[gpos]) <= min_dEng
                dego = np.where(near, deg_h[src[gidx]], 0)
                degn[gsl[starts]] = np.add.reduceat(dego, starts)

            # droplet recording: trees are shared with the parent branch
            # (copy on append); the cdE filter and state XORs run over all
            # losers of the site at once
            psrc = src[rep]
            new_el = [ins.el[int(p)] if v else []
                      for p, v in zip(psrc, out_valid)]
            if len(gidx):
                rep_of_group = rep[gsl[starts]]
                gpos = np.repeat(np.arange(len(starts)), ends - starts)
                cdE_all = E_cand[gidx] - E_cand[rep_of_group[gpos]]
                sel = (gidx != rep_of_group[gpos]) & (cdE_all <= max_dEng)
                l_idx, l_grp, l_cdE = gidx[sel], gpos[sel], cdE_all[sel]
                if l_idx.size:
                    lr = rep_of_group[l_grp]
                    st_l = states_h[src[l_idx]]
                    st_l[:, col] = indc[l_idx]
                    st_r = states_h[src[lr]]
                    st_r[:, col] = indc[lr]
                    dx = np.bitwise_xor(st_r, st_l)
                    rows_nz, cols_nz = np.nonzero(dx)
                    bounds = np.searchsorted(rows_nz,
                                             np.arange(len(l_idx) + 1))
                    elem = None
                    if ee == 2:
                        # the site's connectivity checks in one native call
                        elem = _elem_batch(ins, cols_nz,
                                           dx[rows_nz, cols_nz], bounds)
                    gs2 = np.flatnonzero(np.r_[True, l_grp[1:] != l_grp[:-1]])
                    ge2 = np.r_[gs2[1:], len(l_grp)]
                    slot_of_group = gsl[starts]
                    for a, e in zip(gs2, ge2):
                        kk = int(slot_of_group[l_grp[a]])
                        bel = new_el[kk][:]
                        losers = []
                        for t in range(a, e):
                            ii = int(l_idx[t])
                            dpos = cols_nz[bounds[t]:bounds[t + 1]] \
                                .astype(np.int64)
                            if dpos.size == 0:
                                # a loser identical to its representative
                                # carries no droplet (only where a pull-cap
                                # overflow clamped the rep; flagged)
                                continue
                            losers.append((l_cdE[t], dpos,
                                           dx[t, dpos].astype(np.int64),
                                           cprob[ii] - out_prob[kk],
                                           ins.el[src[ii]],
                                           None if elem is None
                                           else bool(elem[t])))
                        record_losers(ins, ee, bel, losers, ny, nx, Nx,
                                      max_dEng, lim_hd)
                        new_el[kk] = bel

            # the replayed beam update
            Eng_h = np.where(out_valid, E_cand[rep], 0.0)
            states_h = states_h[psrc]
            states_h[:, col] = indc[rep]
            vind_h = vind_h[psrc]
            vind_h[:, nx] = dmap[ny, nx][indc[rep]]
            vind_h[:, nx + 1] = rmap[ny, nx][indc[rep]]
            deg_h = degn
            ins.el = new_el
            if ee < 3 and len(ins.d) > gc_watermark:
                # gc only reclaims memory: walk the trees when the shape
                # dictionary has doubled, not at every site
                exc_gc(ins)
                gc_watermark = max(1024, 2 * len(ins.d))
        if ee == 3:
            exc_gc(ins)
        logger.info("Row %d/%d replayed: %d branches, %d shapes, %.2f s",
                    ny + 1, Ny, int(out_valid.sum()), len(ins.d),
                    time.time() - t_row)
        vind_h[:, 1:] = vind_h[:, :-1]
        vind_h[:, 0] = 0

    if overflow:
        logger.warning(
            "candidate cap C=%d exceeded at %d sites (max post-cutoff count "
            "%d): some merge losers were not recorded; cand_factor >= %d "
            "makes the spectrum complete", C, overflow, count_max,
            -(-count_max // M))
    if globalmin < -0.5:
        logger.warning("negative_probability %.3g saturated at site (ny=%d, "
                       "nx=%d); within the cutoff %.3g", globalmin,
                       *negp_site, globalmin_core)
    keep = np.flatnonzero(out_valid)
    ins.el = [ins.el[kk] for kk in keep]
    if ee < 3:
        exc_gc(ins)      # d holds live shapes only, as the reference's
    _finalize_spectrum(ins, ee, lim_hd)
    return SearchResult(
        energy=Eng_h[keep], probability=out_prob[keep],
        degeneracy=int(deg_h[keep[0]]), states=states_h[keep],
        discarded_probability=float(pd_max),
        negative_probability=min(globalmin, 0.0),
        negative_probability_core=min(globalmin_core, 0.0),
        merge_overflow=overflow, count_max=count_max)


def multi_search_spectrum(inss, ctxs, excitations_encoding, M=2 ** 10,
                          relative_P_cutoff=1e-6, max_dEng=0.0, lim_hd=0,
                          min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                          max_sweeps=20, graduate_truncation=True,
                          cand_factor=8, n_live=None, zipup_rsvd=None,
                          omega=None, native=True, stage_times=None):
    """Device-record spectrum search over same-shape instances (tnax's
    ``multi_search_spectrum``, spectrum.py:1192-1284; the production
    pattern of the reference's e03): one context of the B instances (their
    gauges stacked), one boundary build and one records run with the
    instance axis, then each instance replayed on the host from its slice
    of the records. ``inss``/``ctxs`` are parallel lists of Solvers and
    their contexts. No auto-grow here: callers read each result's
    ``merge_overflow`` and retry stragglers alone. ``n_live``, if given,
    replays only the first n_live instances (the rest pad a batch).
    ``zipup_rsvd``/``omega``: the stack's zip-up (``ContractionContext.
    build_boundary``); ``native``: the droplet store's C code or its NumPy
    versions; ``stage_times``, if a dict, receives the seconds of the
    boundary, the records (device, ended by a synchronize, which stops the
    copies from overlapping the replay) and the replay (host). Returns a
    list of ``search.SearchResult``.
    """
    if not inss or len(inss) != len(ctxs):
        raise ValueError("need parallel, non-empty lists of solvers and "
                         "contexts")
    ctx = ContractionContext.stack(list(ctxs))
    for ins in inss:
        ins.excitations_encoding = excitations_encoding
    return _search(inss, ctx, excitations_encoding, M=M,
                   relative_P_cutoff=relative_P_cutoff, max_dEng=max_dEng,
                   lim_hd=lim_hd, min_dEng=min_dEng, Dmax=Dmax, tolS=tolS,
                   tolV=tolV, max_sweeps=max_sweeps,
                   graduate_truncation=graduate_truncation,
                   cand_factor=cand_factor, n_live=n_live,
                   zipup_rsvd=zipup_rsvd, omega=omega, native=native,
                   stage_times=stage_times)


def device_search_spectrum(ins, ctx, excitations_encoding, M=2 ** 10,
                           relative_P_cutoff=1e-6, max_dEng=0.0, lim_hd=0,
                           min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                           max_sweeps=20, graduate_truncation=True,
                           cand_factor=8, zipup_rsvd=None, omega=None,
                           native=True, stage_times=None):
    """Device-record spectrum search of one instance (tnax's
    ``device_search_spectrum``, spectrum.py:904-983) on its context
    ``ctx``: the boundary stack, the records of every row on the device,
    and the host replay, which overlaps the device's later rows.

    Semantics match tnax's: branch selection (cutoff, merge
    representative, top-M) resolves at the compute dtype's precision, the
    candidate set is capped at ``cand_factor * M`` per site (None: the
    full M*Np expansion, which kernel K2 takes) with the candidate order
    of :func:`records_select`, and the recorded droplet energies are exact
    float64. ``merge_overflow`` in the result counts the sites where the
    cap or the pull cap dropped candidates. ``stage_times``, if a dict,
    receives the seconds of the boundary, the records (device) and the
    replay (host); ``native`` as in :func:`multi_search_spectrum`.
    Returns a ``search.SearchResult``.
    """
    return _search([ins], ctx, excitations_encoding, M=M,
                   relative_P_cutoff=relative_P_cutoff, max_dEng=max_dEng,
                   lim_hd=lim_hd, min_dEng=min_dEng, Dmax=Dmax, tolS=tolS,
                   tolV=tolV, max_sweeps=max_sweeps,
                   graduate_truncation=graduate_truncation,
                   cand_factor=cand_factor, zipup_rsvd=zipup_rsvd,
                   omega=omega, native=native, stage_times=stage_times)[0]


def _search(inss, ctx, ee, *, M, relative_P_cutoff, max_dEng, lim_hd,
            min_dEng, Dmax, tolS, tolV, max_sweeps, graduate_truncation,
            cand_factor, zipup_rsvd, omega, native, stage_times,
            n_live=None):
    """The spectrum search of the instances ``inss`` of the context
    ``ctx``: boundary, records, replay of each live instance."""
    with StageClock(stage_times, ctx.device) as clock:
        ctx.build_boundary(Dmax, tolS, tolV, max_sweeps, graduate_truncation,
                           rsvd=zipup_rsvd, omega=omega)
        clock.lap("boundary")
        C, P = caps(M, ctx.Np, cand_factor)
        layout, rows = dispatch_records(ctx, M=M, C=C, P=P,
                                        relative_P_cutoff=relative_P_cutoff,
                                        min_dEng=min_dEng)
        clock.lap("records")
    t0 = time.perf_counter()
    results = []
    for b, ins in enumerate(inss[:n_live]):
        ins.droplet_native = native
        results.append(_replay_records(
            ins, ctx, layout, rows, ee, b=b, M=M, C=C, P=P,
            max_dEng=max_dEng, lim_hd=lim_hd, min_dEng=min_dEng))
    if stage_times is not None:
        stage_times["replay"] = stage_times.get("replay", 0.0) \
            + time.perf_counter() - t0
    return results


def sharded_search_spectrum(ins, ctx, excitations_encoding, mesh, M=2 ** 10,
                            relative_P_cutoff=1e-6, max_dEng=0.0, lim_hd=0,
                            min_dEng=1e-12, Dmax=32, tolS=1e-16, tolV=1e-10,
                            max_sweeps=20, graduate_truncation=True,
                            cand_factor=8, zipup_rsvd=None, omega=None,
                            native=True, stage_times=None):
    """Device-record spectrum search of one instance with its M branches
    sharded over the mesh's 'beam' axis (tnax's
    ``sharded_search_spectrum``, spectrum.py:1286-1353). Every rank
    passes the same instance and context (on its mesh device). The
    stack is built on the axis's first rank and broadcast
    (``parallel.beam_boundary``), the candidate cap loses its remainder
    modulo the axis size, each site runs on the ranks' branches with the
    candidates in the "topk" order, and the records are the same on every
    rank, so each rank's host replay is the single card's
    :func:`_replay_records` and every rank returns the same
    ``search.SearchResult``. M must tile the beam axis (ValueError).
    ``zipup_rsvd``, ``omega``, ``native`` and ``stage_times`` as in
    :func:`device_search_spectrum`.
    """
    axis = par._mesh.check_mesh(mesh).axis("beam")
    axis.block(M)
    par._check_mesh_device(ctx.device, mesh)
    ins.excitations_encoding = excitations_encoding
    with StageClock(stage_times, ctx.device) as clock:
        rhoT = par.beam_boundary(ctx, axis, Dmax, tolS, tolV, max_sweeps,
                                 graduate_truncation, rsvd=zipup_rsvd,
                                 omega=omega)
        clock.lap("boundary")
        C, P = caps(M, ctx.Np, cand_factor, axis.size)
        layout, rows = dispatch_records(ctx, M=M, C=C, P=P,
                                        relative_P_cutoff=relative_P_cutoff,
                                        min_dEng=min_dEng, rhoT=rhoT,
                                        axis=axis)
        clock.lap("records")
    t0 = time.perf_counter()
    ins.droplet_native = native
    res = _replay_records(ins, ctx, layout, rows, excitations_encoding, b=0,
                          M=M, C=C, P=P, max_dEng=max_dEng, lim_hd=lim_hd,
                          min_dEng=min_dEng)
    if stage_times is not None:
        stage_times["replay"] = stage_times.get("replay", 0.0) \
            + time.perf_counter() - t0
    return res
