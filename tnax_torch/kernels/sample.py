"""K4: the Gibbs sampler's per-site draw (``tnax.engine.marginal_step``
after its two GEMMs, then the inverse-CDF draw of
``tnax.parallel.sample_rows``).

:func:`sample_draw` launches the CUDA kernel in ``csrc/sample.cu`` for
CUDA tensors and runs :func:`sample_draw_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .marginal import marginal_pn_plain

NP_MAX = 4096   # the kernel holds a row of Np words in shared memory


def sample_draw_plain(T2, lB, drindex, lidx, uidx, nvalid, u):
    """One draw per walker from its normalized conditional marginal.

    T2 (B, M, lv*lh), lB (B, Np, lh, lv), drindex (B, Np), lidx/uidx
    (B, M) and nvalid (B,) as in :func:`marginal.marginal_pn_plain`; u
    (B, M) uniforms in [0, 1) in the dtype of T2. With Pn the marginals,
    the drawn state is the number of cumulative sums of Pn below u,
    clipped to [0, nvalid - 1] (tnax parallel.py:1295-1299). Returns
    (indc (B, M) int32, mPn (B, M)).
    """
    Pn, mPn = marginal_pn_plain(T2, lB, drindex, lidx, uidx, nvalid)
    cums = torch.cumsum(Pn, dim=2)
    count = (cums < u[..., None]).sum(dim=2)
    top = nvalid.reshape(-1, 1).long() - 1
    indc = torch.minimum(torch.clamp(count, min=0), top)
    return indc.to(torch.int32), mPn


def draw_mismatches(got, want, args):
    """Compare K4's draws ``got`` with the plain version's ``want`` (both
    (B, M)) on the inputs ``args`` of :func:`sample_draw`. Returns (the
    number of draws that differ, the number of those that rounding does
    not explain). The kernel's scan adds in another order than
    torch.cumsum, so a draw may differ only where the plain version's
    cumulative sums between the two drawn indices lie within 64 eps of
    the walker's uniform."""
    u = args[6]
    cums = torch.cumsum(marginal_pn_plain(*args[:6])[0], dim=2)
    eps = torch.finfo(u.dtype).eps
    bad = (got != want).nonzero().tolist()
    unexplained = 0
    for b, m in bad:
        lo, hi = sorted((int(got[b, m]), int(want[b, m])))
        near = (cums[b, m, lo:hi] - u[b, m]).abs() <= 64 * eps
        unexplained += not bool(near.all())
    return len(bad), unexplained


def sample_draw(T2, lB, drindex, lidx, uidx, nvalid, u):
    """The per-site draw of B instances' walkers; the CUDA kernel on CUDA
    tensors (one launch, one block per walker), the plain version on CPU
    tensors. See :func:`sample_draw_plain`."""
    if T2.device.type == "cpu":
        return sample_draw_plain(T2, lB, drindex, lidx, uidx, nvalid, u)
    if T2.device.type != "cuda":
        raise ValueError(f"sample_draw: unsupported device {T2.device}")
    B, M = T2.shape[:2]
    Np, lh, lv = lB.shape[1:]
    dtype, dev = T2.dtype, T2.device
    if dtype not in (torch.float32, torch.float64) or lB.dtype != dtype \
            or u.dtype != dtype:
        raise ValueError(f"sample_draw: T2, lB and u must share float32 or "
                         f"float64, got {T2.dtype}, {lB.dtype}, {u.dtype}")
    if T2.shape != (B, M, lh * lv) or lB.shape[0] != B or \
            drindex.shape != (B, Np) or lidx.shape != (B, M) or \
            uidx.shape != (B, M) or nvalid.shape != (B,) or \
            u.shape != (B, M):
        raise ValueError("sample_draw: inconsistent shapes")
    if not 1 <= Np <= NP_MAX:
        raise ValueError(f"sample_draw: the kernel takes 1..{NP_MAX} states, "
                         f"got {Np}")
    for t in (lB, drindex, lidx, uidx, nvalid, u):
        if t.device != dev:
            raise ValueError(f"sample_draw: all inputs must lie on {dev}, "
                             f"got {t.device}")
        if t.dtype not in (dtype, torch.int32, torch.int64):
            raise ValueError(f"sample_draw: unsupported dtype {t.dtype}")

    def i32(t):
        return t.to(torch.int32).contiguous()

    T2, lB, u = T2.contiguous(), lB.contiguous(), u.contiguous()
    ints = [i32(t) for t in (drindex, lidx, uidx, nvalid)]
    indc = torch.empty((B, M), dtype=torch.int32, device=dev)
    mPn = torch.empty((B, M), dtype=dtype, device=dev)
    dll = build.load("sample")
    fn = dll.tnax_sample_draw_f64 if dtype == torch.float64 else \
        dll.tnax_sample_draw_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = fn(build.ptr(T2), build.ptr(lB), *(build.ptr(t) for t in ints),
             build.ptr(u), B, M, Np, lh * lv, lv, build.ptr(indc),
             build.ptr(mPn), build.stream(dev))
    build.check(dll, err, "sample_draw")
    sample_draw.launches += 1
    return indc, mPn


sample_draw.launches = 0
