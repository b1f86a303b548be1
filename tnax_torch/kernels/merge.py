"""K2: beam-merge grouping and segment statistics
(the key1 path of ``tnax.parallel.merge_candidates``).

:func:`merge_segments` launches the CUDA kernels in ``csrc/merge.cu`` for
CUDA tensors, for any number of candidates C (one launch of one block per
instance up to C = 4096, a sequence of tiled launches beyond), and runs
:func:`merge_segments_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG = -1e30    # effectively -inf log2 probability (tnax.parallel.NEG)
B_MAX = 65535  # instances per launch (the grid's second dimension)


def segment_stats_plain(perm, neq, Eng, prob, valid, deg, min_dEng):
    """Per-segment statistics of each instance's candidates sorted by
    ``perm`` (B, C), where ``neq`` (B, C-1) flags a new group at sorted
    position i+1.

    Returns (seg (B, C) segment id per sorted position, Emin, first_min
    (sorted position of the first minimum-energy valid member, C if none),
    gprob (mean log2-probability of the members within ``min_dEng`` of
    Emin, NEG for groups with no valid member), deg_seg (their int64
    degeneracy sum)), the statistics indexed by segment id over C slots.
    """
    B, C = Eng.shape
    dev = Eng.device
    Es, ps, vls, ds = (torch.gather(t, 1, perm)
                       for t in (Eng, prob, valid, deg))
    seg = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                     torch.cumsum(neq, 1)], dim=1)
    big = torch.finfo(Es.dtype).max
    Emin = torch.full((B, C), big, dtype=Es.dtype, device=dev).scatter_reduce(
        1, seg, torch.where(vls, Es, big), "amin")
    Emin_s = torch.gather(Emin, 1, seg)
    is_min = (Es == Emin_s) & vls
    pos = torch.arange(C, device=dev).expand(B, C)
    first_min = torch.full((B, C), C, dtype=torch.int64, device=dev)
    first_min = first_min.scatter_reduce(1, seg, torch.where(is_min, pos, C),
                                         "amin")
    near = ((Es - Emin_s) <= min_dEng) & vls
    zeros = torch.zeros((B, C), dtype=ps.dtype, device=dev)
    n_near = zeros.scatter_add(1, seg, near.to(ps.dtype))
    psum = zeros.scatter_add(1, seg, torch.where(near, ps, 0.0))
    prob_mean = psum / torch.clamp(n_near, min=1.0)
    gprob = torch.where(first_min < C, prob_mean, NEG)
    deg_seg = torch.zeros((B, C), dtype=torch.int64, device=dev).scatter_add(
        1, seg, torch.where(near, ds, 0))
    return seg, Emin, first_min, gprob, deg_seg


def merge_segments_plain(key1, Eng, prob, valid, deg, min_dEng):
    """Stable sort of each instance's row of ``key1`` (B, C) int32, then
    :func:`segment_stats_plain`. (C,) inputs are the case B = 1 and give
    (C,) outputs. Returns (perm, seg, Emin, first_min, gprob, deg_seg)."""
    if key1.dim() == 1:
        out = merge_segments_plain(*(t[None] for t in (key1, Eng, prob,
                                                      valid, deg)), min_dEng)
        return tuple(t[0] for t in out)
    ks, perm = torch.sort(key1, dim=1, stable=True)
    neq = ks[:, 1:] != ks[:, :-1]
    return (perm,) + segment_stats_plain(perm, neq, Eng, prob, valid, deg,
                                         min_dEng)


# the entry points' arguments: five (pointer, row stride) inputs, min_dEng,
# NEG, C, B, key_bits (-1: none), six outputs, the scratch and the stream
_ARGS = ((ctypes.c_void_p, ctypes.c_longlong) * 5
         + (ctypes.c_double, ctypes.c_double) + (ctypes.c_int,) * 3
         + (ctypes.c_void_p,) * 8)


@functools.lru_cache(maxsize=64)
def _scratch_bytes(B, C, f64):
    fn = build.fn("merge", "tnax_merge_scratch_bytes", (ctypes.c_int,) * 3,
                  ctypes.c_longlong)
    return int(fn(B, C, int(f64)))


def merge_segments(key1, Eng, prob, valid, deg, min_dEng, key_bits=None):
    """Grouping and segment statistics of the merge of B instances; the
    CUDA kernel on CUDA tensors (any C >= 1), the plain version on CPU
    tensors. See :func:`merge_segments_plain`.

    ``key_bits`` (kb), if given, is the caller's promise that every key
    lies in [0, 2**kb): the kernel then sorts kb bits, ceil(kb / 8) radix
    passes; without it all 32 bits, 4 passes. The plain version sorts the
    whole keys either way, which is the same order when the promise holds.
    """
    if key1.device.type == "cpu":
        return merge_segments_plain(key1, Eng, prob, valid, deg, min_dEng)
    if key1.device.type != "cuda":
        raise ValueError(f"merge_segments: unsupported device {key1.device}")
    if key1.dim() == 1:
        out = merge_segments(*(t[None] for t in (key1, Eng, prob, valid,
                                                deg)), min_dEng, key_bits)
        return tuple(t[0] for t in out)
    if key1.dim() != 2:
        raise ValueError(f"merge_segments: keys must be (C,) or (B, C), got "
                         f"{tuple(key1.shape)}")
    B, C = key1.shape
    if C < 1 or not 1 <= B <= B_MAX:
        raise ValueError(f"merge_segments: the kernel takes C >= 1 and "
                         f"1..{B_MAX} instances, got ({B}, {C})")
    if key_bits is not None and not 0 <= key_bits <= 31:
        raise ValueError(f"merge_segments: key_bits must lie in 0..31, got "
                         f"{key_bits}")
    if prob.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"merge_segments: probabilities must be float32/64, "
                         f"got {prob.dtype}")
    for t, dt in ((key1, torch.int32), (Eng, torch.float64),
                  (prob, prob.dtype), (valid, torch.bool),
                  (deg, torch.int64)):
        if t.dtype != dt or t.shape != (B, C) or t.device != key1.device:
            raise ValueError(f"merge_segments: expected ({B}, {C}) {dt} on "
                             f"{key1.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    # rows may be strided (the caller's top-C slices), elements not
    ins = [t if t.stride(1) == 1 else t.contiguous()
           for t in (key1, Eng, prob, valid, deg)]
    dev = key1.device
    f64 = prob.dtype == torch.float64
    # perm, seg, first_min, deg_seg and Emin in one allocation
    ints = torch.empty((5, B, C), dtype=torch.int64, device=dev)
    perm, seg, first_min, deg_seg = ints[:4]
    Emin = ints[4].view(torch.float64)
    gprob = torch.empty((B, C), dtype=prob.dtype, device=dev)
    scratch = torch.empty(_scratch_bytes(B, C, f64), dtype=torch.uint8,
                          device=dev)
    fn = build.fn("merge", "tnax_merge_f64" if f64 else "tnax_merge_f32",
                  _ARGS)
    err = fn(*(x for t in ins for x in (t.data_ptr(), t.stride(0))),
             float(min_dEng), NEG, C, B,
             -1 if key_bits is None else int(key_bits),
             *(t.data_ptr() for t in (perm, seg, Emin, first_min, gprob,
                                      deg_seg, scratch)),
             build.raw_stream(dev))
    build.check(build.load("merge"), err, "merge_segments")
    merge_segments.launches += 1
    return perm, seg, Emin, first_min, gprob, deg_seg


merge_segments.launches = 0
