"""K6: the zip-up and truncation sweep of one boundary-MPS row absorption
(everything ``bmps.compress_apply`` does before the polish) in one
launch.

:func:`zipup_row` launches the CUDA kernel in ``csrc/zipup.cu`` for CUDA
tensors and runs :func:`zipup_row_plain` (``bmps.zipup_truncate``: the
plain canonization, zip-up with the randomized sketch and truncation
sweep) for CPU tensors. :func:`engages` says which rows
``bmps.compress_apply`` hands to K6: float32 on the card at the shapes
the kernel is built for, with the sketch. Those are the rows K5
(``kernels.polish``) then polishes.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the kernel's shapes: the row's bond of 8 (the zip-up's of 16); the
# physical and MPO legs of 16; at most 16 sites; the sketch's rank of 48
BOND, LEG, MAX_SITES = 8, 16, 16
SKETCH = (BOND * LEG, 2 * BOND + 32)


def zipup_row_plain(A, lognorm, Wc, omega, *, tolS):
    """The three steps in plain torch (``bmps.zipup_truncate`` at bond
    8): A (B, L, 8, 16, 8) the row's input MPS and lognorm (B,) its log2
    scale, Wc (B, L, l, d, r, u) the row's MPO oriented
    (``bmps._orient_mpo``), omega (L, 128, 48) the sketch, tolS the
    truncation's tolerance (``compress_apply``'s, at least eps). Returns
    (phi_A (B, L, 8, 16, 8), phi_lognorm (B,), A0 (B, L, 8, 16, 8),
    discarded (B,)): the right-canonized input and its lognorm, the
    zip-up truncated to bond 8, the larger discarded weight."""
    from .. import bmps
    phi, A0, disc = bmps.zipup_truncate(bmps.MPS(A=A, lognorm=lognorm), Wc,
                                        BOND, tolS=tolS, rsvd=True,
                                        omega=omega)
    return phi.A, phi.lognorm, A0.A, disc


def _shapes_fit(A, Wc, omega):
    if A.dim() != 5 or Wc.dim() != 6 or omega is None or omega.dim() != 3:
        return False
    B, L = A.shape[:2]
    return (1 <= L <= MAX_SITES
            and tuple(A.shape[2:]) == (BOND, LEG, BOND)
            and tuple(Wc.shape) == (B, L) + (LEG,) * 4
            and tuple(omega.shape) == (L,) + SKETCH)


def engages(A, Wc, omega) -> bool:
    """Whether K6 takes a row: float32 CUDA tensors on one card at the
    kernel's shapes (A (B, L, 8, 16, 8), Wc (B, L, 16, 16, 16, 16), 1 <=
    L <= 16) zipped up with the sketch ``omega`` (L, 128, 48); None for
    ``omega`` (the exact SVD, ``rsvd=False``) does not engage. Decided
    from the tensors alone, without a device read."""
    if omega is None:
        return False
    ts = (A, Wc, omega)
    return (all(t.device.type == "cuda" and t.dtype == torch.float32
                for t in ts)
            and len({t.device for t in ts}) == 1 and _shapes_fit(*ts))


# the entry point's arguments: A and its five strides, lognorm and its
# stride, W and its batch and site strides, the sketch, B, L, the two
# tolerances, the five outputs (the scratch last), the stream
_ARGS = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 5
         + (ctypes.c_void_p, ctypes.c_longlong)
         + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong)
         + (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_double)
         + (ctypes.c_void_p,) * 6)


def zipup_row(A, lognorm, Wc, omega, *, tolS):
    """The zip-up and truncation sweep of one row: K6 on CUDA tensors
    (one launch, one block per lane, no host read), the plain version on
    CPU tensors. See :func:`zipup_row_plain`. Raises ValueError for any
    dtype, shape or device K6 does not take."""
    ts = (A, lognorm, Wc, omega)
    if all(t.device.type == "cpu" for t in ts):
        return zipup_row_plain(A, lognorm, Wc, omega, tolS=tolS)
    if not all(t.device.type == "cuda" for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError(f"zipup_row: A, lognorm, Wc and omega must lie on "
                         f"one CUDA card, got {[str(t.device) for t in ts]}")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"zipup_row: K6 takes float32, got "
                         f"{[t.dtype for t in ts]}")
    if not _shapes_fit(A, Wc, omega) or \
            tuple(lognorm.shape) != (A.shape[0],):
        raise ValueError(
            f"zipup_row: K6 takes A (B, L, 8, 16, 8), lognorm (B,), Wc (B, "
            f"L, 16, 16, 16, 16) and omega (L, 128, 48) with 1 <= L <= "
            f"{MAX_SITES}, got {tuple(A.shape)}, {tuple(lognorm.shape)}, "
            f"{tuple(Wc.shape)}, {tuple(omega.shape)}")
    if Wc.stride()[2:] != (LEG ** 3, LEG ** 2, LEG, 1) \
            or Wc.stride(0) % 4 or Wc.stride(1) % 4 or Wc.data_ptr() % 16:
        # the kernel streams each site's W in 16-byte pieces
        Wc = Wc.contiguous()
    omega = omega.contiguous()
    eps = torch.finfo(torch.float32).eps
    B, L = A.shape[:2]
    dev = A.device
    phi = torch.empty((B, L, BOND, LEG, BOND), dtype=A.dtype, device=dev)
    phi_ln = torch.empty((B,), dtype=A.dtype, device=dev)
    A0 = torch.empty((B, L, BOND, LEG, BOND), dtype=A.dtype, device=dev)
    disc = torch.empty((B,), dtype=A.dtype, device=dev)
    scratch = torch.empty((B, L, 2 * BOND * LEG, 2 * BOND), dtype=A.dtype,
                          device=dev)
    fn = build.fn("zipup", "tnax_zipup_f32", _ARGS)
    err = fn(A.data_ptr(), *A.stride(), lognorm.data_ptr(), lognorm.stride(0),
             Wc.data_ptr(), Wc.stride(0), Wc.stride(1), omega.data_ptr(), B,
             L, max(eps, tolS / 10), max(eps, tolS), phi.data_ptr(),
             phi_ln.data_ptr(), A0.data_ptr(), disc.data_ptr(),
             scratch.data_ptr(), build.raw_stream(dev))
    build.check(build.load("zipup"), err, "zipup_row")
    zipup_row.launches += 1
    return phi, phi_ln, A0, disc


zipup_row.launches = 0
