"""K1: LAPACK-style balancing scales (``tnax.precondition.gebal_scale``).

:func:`gebal_scale` launches the CUDA kernel in ``csrc/gebal.cu`` for
CUDA tensors and runs :func:`gebal_scale_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def gebal_scale_plain(A, nd, max_scale):
    """Balancing scales of a batch of matrices, plain torch.

    A (..., n, n); nd (...,) number of leading rows/columns to balance;
    returns scale (..., n): the no-permutation scaling pass of LAPACK
    ``gebal`` (scipy's ``matrix_balance(permute=False, separate=True)``),
    powers of two, clipped to ``[1/max_scale, max_scale]``; padded
    rows/columns keep scale 1.

    Lanes run together: a lane whose pass changed nothing sees the same
    matrix in every later pass and changes nothing again, so running the
    converged lanes along is exact. The two scaling loops test their
    condition on the host.
    """
    shape = A.shape
    n = shape[-1]
    A = A.reshape(-1, n, n)
    nd = torch.as_tensor(nd, device=A.device).reshape(-1)
    mask = torch.arange(n, device=A.device)[None, :] < nd[:, None]
    A = torch.where(mask[:, :, None] & mask[:, None, :], A, 0.0)
    scale = torch.ones(A.shape[:2], dtype=A.dtype, device=A.device)
    noconv = True
    for _ in range(64):
        if not noconv:
            break
        changed = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
        for i in range(n):
            c = torch.linalg.vector_norm(A[:, :, i], dim=1)
            r = torch.linalg.vector_norm(A[:, i, :], dim=1)
            ok = (c > 0) & (r > 0) & mask[:, i]
            s = c + r
            one = torch.ones_like(c)
            c = torch.where(ok, c, one)
            r = torch.where(ok, r, one)
            f = one
            while True:                       # grow f while c < r/2
                act = c < r * 0.5
                if not act.any():
                    break
                c = torch.where(act, c * 2.0, c)
                r = torch.where(act, r * 0.5, r)
                f = torch.where(act, f * 2.0, f)
            while True:                       # shrink f while c/2 >= r
                act = c * 0.5 >= r
                if not act.any():
                    break
                c = torch.where(act, c * 0.5, c)
                r = torch.where(act, r * 2.0, r)
                f = torch.where(act, f * 0.5, f)
            apply = ok & ((c + r) < 0.95 * s) & (f != 1.0)
            f = torch.where(apply, f, one)
            A[:, :, i] = A[:, :, i] * f[:, None]
            A[:, i, :] = A[:, i, :] / f[:, None]
            scale[:, i] = scale[:, i] * f
            changed |= apply
        noconv = bool(changed.any())
    scale = torch.clamp(scale, 1.0 / max_scale, max_scale)
    return scale.reshape(shape[:-1])


# the entry points' arguments: A and its batch, row and column strides, nd
# with its stride and width flag, max_scale, n, the batch, out, the stream
_ARGS = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 3
         + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p))


def gebal_scale(A, nd, max_scale):
    """Balancing scales; the CUDA kernel on CUDA tensors (one launch, one
    matrix per half-warp for n <= 16), the plain version on CPU tensors.
    See :func:`gebal_scale_plain`. On the card ``nd`` is an int32 or int64
    tensor, read in place at any stride, as is ``A``."""
    if A.device.type == "cpu":
        return gebal_scale_plain(A, nd, max_scale)
    if A.device.type != "cuda":
        raise ValueError(f"gebal_scale: unsupported device {A.device}")
    shape = A.shape
    n = shape[-1]
    if A.dim() < 2 or shape[-2] != n or not 1 <= n <= 32:
        raise ValueError(f"gebal_scale: need square matrices with n <= 32, "
                         f"got {tuple(shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"gebal_scale: unsupported dtype {A.dtype}")
    A = A.reshape(-1, n, n)
    nd = torch.as_tensor(nd, device=A.device).reshape(-1)
    if nd.dtype not in (torch.int32, torch.int64) or nd.device != A.device:
        raise ValueError(f"gebal_scale: nd must be int32 or int64 on "
                         f"{A.device}, got {nd.dtype} on {nd.device}")
    if nd.shape[0] != A.shape[0]:
        raise ValueError("gebal_scale: one nd per matrix")
    out = torch.empty(A.shape[:2], dtype=A.dtype, device=A.device)
    fn = build.fn("gebal", "tnax_gebal_f64" if A.dtype == torch.float64
                  else "tnax_gebal_f32", _ARGS)
    err = fn(A.data_ptr(), *A.stride(), nd.data_ptr(), nd.stride(0),
             int(nd.dtype == torch.int64), float(max_scale), n, A.shape[0],
             out.data_ptr(), build.raw_stream(A.device))
    build.check(build.load("gebal"), err, "gebal_scale")
    gebal_scale.launches += 1
    return out.reshape(shape[:-1])


gebal_scale.launches = 0
