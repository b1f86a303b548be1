"""K7: the singular value decomposition of every matrix of a float32 batch
in one launch, with no host read.

:func:`svd_fixed` returns what ``bmps.svd_fixed`` returns (U, S
descending, Vh, with its column-sign rule) and :func:`svdvals` S alone. On
CUDA tensors
each launches the CUDA kernel in ``csrc/svd.cu``; on CPU tensors each runs
its plain version (:func:`svd_fixed_plain`, :func:`svdvals_plain`: the
``torch.linalg`` calls, which on the card check cuSOLVER's info on the host
after every call). :func:`engages` says which matrices ``bmps.svd_fixed``
and ``bmps.svdvals`` hand to K7: float32 on the card with p = min(m, n) of
at most 128 and max(m, n) of at most 4096, which takes every SVD of the
boundary's row absorption at Dmax 32 and 48 (the zip-up's sketched core,
the truncation sweep, the polish's singular values).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the kernel's envelope: p = min(m, n) and q = max(m, n)
MAX_P, MAX_Q = 128, 4096


def svd_fixed_plain(M):
    """U, S, Vh of each matrix of M (..., m, n) by ``torch.linalg.svd``
    with ``bmps.svd_fixed``'s column-sign rule."""
    from .. import bmps
    return bmps.svd_fixed_plain(M)


def svdvals_plain(M):
    """The singular values of each matrix of M (..., m, n), descending."""
    return torch.linalg.svdvals(M)


def _shapes_fit(shape) -> bool:
    """Whether K7 takes a batch of this shape (..., m, n): at least one
    matrix, 1 <= min(m, n) <= 128, max(m, n) <= 4096."""
    if len(shape) < 2 or any(s < 1 for s in shape):
        return False
    m, n = shape[-2:]
    return min(m, n) <= MAX_P and max(m, n) <= MAX_Q


def engages(M) -> bool:
    """Whether K7 takes M: a float32 CUDA tensor within the envelope
    (:func:`_shapes_fit`). Decided from the tensor alone, without a device
    read."""
    return (M.device.type == "cuda" and M.dtype == torch.float32
            and _shapes_fit(M.shape))


# the entry point's arguments: X and its three strides, S and its batch
# stride, U_X and its three, V_X and its three, the sweeps, B, p, q,
# vectors, the stream
_ARGS = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 3
         + (ctypes.c_void_p, ctypes.c_longlong)
         + ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 3) * 2
         + (ctypes.c_void_p,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


def _check(M, what):
    if M.device.type != "cuda":
        raise ValueError(f"{what}: M must lie on a CUDA card or the CPU, got "
                         f"{M.device}")
    if M.dtype != torch.float32:
        raise ValueError(f"{what}: K7 takes float32, got {M.dtype}")
    if not _shapes_fit(M.shape):
        raise ValueError(f"{what}: K7 takes (..., m, n) with 1 <= min(m, n) "
                         f"<= {MAX_P} and max(m, n) <= {MAX_Q}, got "
                         f"{tuple(M.shape)}")


def _launch(M, vectors, sweeps):
    """K7 on M (..., m, n): S, and U and Vh when ``vectors``. The kernel
    factors the wide orientation X (p x q) of each matrix, M or M^T, and
    writes X's U (p x p) and V (q x p) through strides into M's U and Vh;
    ``sweeps`` (an int32 tensor of the batch's size, or None) takes each
    matrix's Jacobi sweeps."""
    m, n = M.shape[-2:]
    batch = M.shape[:-2]
    X = M.reshape(-1, m, n)
    B, p, q = X.shape[0], min(m, n), max(m, n)
    dev = M.device
    S = torch.empty((B, p), dtype=M.dtype, device=dev)
    xs = X.stride()
    if vectors:
        U = torch.empty((B, m, p), dtype=M.dtype, device=dev)
        Vh = torch.empty((B, p, n), dtype=M.dtype, device=dev)
        su, sv = U.stride(), Vh.stride()
        if m <= n:      # X = M: U_X is U, V_X is Vh^T
            xstr = (xs[0], xs[1], xs[2])
            uarg = (U.data_ptr(), su[0], su[1], su[2])
            varg = (Vh.data_ptr(), sv[0], sv[2], sv[1])
        else:           # X = M^T: U_X is Vh^T, V_X is U
            xstr = (xs[0], xs[2], xs[1])
            uarg = (Vh.data_ptr(), sv[0], sv[2], sv[1])
            varg = (U.data_ptr(), su[0], su[1], su[2])
    else:
        xstr = (xs[0], xs[1], xs[2]) if m <= n else (xs[0], xs[2], xs[1])
        uarg = varg = (None, 0, 0, 0)
    fn = build.fn("svd", "tnax_svd_f32", _ARGS)
    err = fn(X.data_ptr(), *xstr, S.data_ptr(), S.stride(0), *uarg, *varg,
             None if sweeps is None else sweeps.data_ptr(), B, p, q,
             int(vectors), build.raw_stream(dev))
    build.check(build.load("svd"), err, "K7")
    svd_fixed.launches += 1
    S = S.reshape(batch + (p,))
    if not vectors:
        return S
    return U.reshape(batch + (m, p)), S, Vh.reshape(batch + (p, n))


def svd_fixed(M, *, sweeps=None):
    """U (..., m, p), S (..., p) descending and Vh (..., p, n) of each
    matrix of M (..., m, n), p = min(m, n), with ``bmps.svd_fixed``'s
    column-sign rule: K7 on a CUDA tensor (one launch, one block a matrix,
    no host read), :func:`svd_fixed_plain` on a CPU tensor. Raises
    ValueError for any dtype, shape or device K7 does not take.

    K7's U and V are orthonormal where S is not negligible; a singular
    value at the rounding noise of a rank-deficient matrix (at most eps
    times its Frobenius norm) is 0 with zero vectors on one side, where
    torch completes an orthonormal set. ``sweeps``, an int32 CUDA tensor
    with one entry a matrix, takes the Jacobi's sweeps."""
    if M.device.type == "cpu":
        return svd_fixed_plain(M)
    _check(M, "svd_fixed")
    return _launch(M, True, sweeps)


def svdvals(M, *, sweeps=None):
    """S (..., p) of each matrix of M (..., m, n), descending: K7 on a
    CUDA tensor, :func:`svdvals_plain` on a CPU tensor; counted among
    :func:`svd_fixed`'s launches. Raises ValueError as :func:`svd_fixed`
    does."""
    if M.device.type == "cpu":
        return svdvals_plain(M)
    _check(M, "svdvals")
    return _launch(M, False, sweeps)


svd_fixed.launches = 0
