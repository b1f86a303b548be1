"""K2: beam-merge grouping and segment statistics
(the key1 path of ``tnax.parallel.merge_candidates``).

:func:`merge_segments` launches the CUDA kernel in ``csrc/merge.cu`` for
CUDA tensors and runs :func:`merge_segments_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

NEG = -1e30   # effectively -inf log2 probability (tnax.parallel.NEG)
C_MAX = 8192  # the kernel's shared-memory sort holds 8192 (key, index) words


def segment_stats_plain(perm, neq, Eng, prob, valid, deg, min_dEng):
    """Per-segment statistics of candidates sorted by ``perm``, where
    ``neq`` (C-1,) flags a new group at sorted position i+1.

    Returns (seg (C,) segment id per sorted position, Emin, first_min
    (sorted position of the first minimum-energy valid member, C if none),
    gprob (mean log2-probability of the members within ``min_dEng`` of
    Emin, NEG for groups with no valid member), deg_seg (their int64
    degeneracy sum)), the statistics indexed by segment id over C slots.
    """
    C = Eng.shape[0]
    dev = Eng.device
    Es, ps, vls, ds = Eng[perm], prob[perm], valid[perm], deg[perm]
    seg = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(neq, 0)])
    big = torch.finfo(Es.dtype).max
    Emin = torch.full((C,), big, dtype=Es.dtype, device=dev).scatter_reduce(
        0, seg, torch.where(vls, Es, big), "amin")
    is_min = (Es == Emin[seg]) & vls
    pos = torch.arange(C, device=dev)
    first_min = torch.full((C,), C, dtype=torch.int64, device=dev)
    first_min = first_min.scatter_reduce(0, seg, torch.where(is_min, pos, C),
                                         "amin")
    near = ((Es - Emin[seg]) <= min_dEng) & vls
    zeros = torch.zeros((C,), dtype=ps.dtype, device=dev)
    n_near = zeros.scatter_add(0, seg, near.to(ps.dtype))
    psum = zeros.scatter_add(0, seg, torch.where(near, ps, 0.0))
    prob_mean = psum / torch.clamp(n_near, min=1.0)
    gprob = torch.where(first_min < C, prob_mean, NEG)
    deg_seg = torch.zeros((C,), dtype=torch.int64, device=dev).scatter_add(
        0, seg, torch.where(near, ds, 0))
    return seg, Emin, first_min, gprob, deg_seg


def merge_segments_plain(key1, Eng, prob, valid, deg, min_dEng):
    """Stable sort by ``key1`` (C,) int32, then :func:`segment_stats_plain`.
    Returns (perm, seg, Emin, first_min, gprob, deg_seg)."""
    ks, perm = torch.sort(key1, stable=True)
    neq = ks[1:] != ks[:-1]
    return (perm,) + segment_stats_plain(perm, neq, Eng, prob, valid, deg,
                                         min_dEng)


def merge_segments(key1, Eng, prob, valid, deg, min_dEng):
    """Grouping and segment statistics of the merge; the CUDA kernel on
    CUDA tensors (C <= 8192), the plain version on CPU tensors. See
    :func:`merge_segments_plain`."""
    if key1.device.type == "cpu":
        return merge_segments_plain(key1, Eng, prob, valid, deg, min_dEng)
    if key1.device.type != "cuda":
        raise ValueError(f"merge_segments: unsupported device {key1.device}")
    C = key1.shape[0]
    if not 1 <= C <= C_MAX:
        raise ValueError(f"merge_segments: the kernel takes 1..{C_MAX} "
                         f"candidates, got {C}")
    if Eng.dtype != torch.float64 or \
            prob.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"merge_segments: energies must be float64 and "
                         f"probabilities float32/64, got {Eng.dtype}, "
                         f"{prob.dtype}")
    for t, dt in ((key1, torch.int32), (valid, torch.bool),
                  (deg, torch.int64)):
        if t.dtype != dt or t.shape != (C,):
            raise ValueError(f"merge_segments: expected ({C},) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    key1, Eng, prob, valid, deg = (t.contiguous() for t in
                                   (key1, Eng, prob, valid, deg))
    dev = key1.device
    i64 = dict(dtype=torch.int64, device=dev)
    perm, seg, first_min, deg_seg = (torch.empty(C, **i64) for _ in range(4))
    Emin = torch.empty(C, dtype=torch.float64, device=dev)
    gprob = torch.empty(C, dtype=prob.dtype, device=dev)
    dll = build.load("merge")
    fn = dll.tnax_merge_f64 if prob.dtype == torch.float64 else \
        dll.tnax_merge_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_double, ctypes.c_double,
                                           ctypes.c_int] \
        + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    err = fn(*(build.ptr(t) for t in (key1, Eng, prob, valid, deg)),
             float(min_dEng), NEG, C,
             *(build.ptr(t) for t in (perm, seg, Emin, first_min, gprob,
                                      deg_seg)),
             build.stream(dev))
    build.check(dll, err, "merge_segments")
    merge_segments.launches += 1
    return perm, seg, Emin, first_min, gprob, deg_seg


merge_segments.launches = 0
