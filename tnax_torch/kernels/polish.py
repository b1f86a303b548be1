"""K5: the variational polish of one boundary-MPS row absorption
(``bmps.variational_implicit``'s sweeps and stop loop) in one launch.

:func:`polish_row` launches the CUDA kernel in ``csrc/polish.cu`` for
CUDA tensors and runs :func:`polish_row_plain` (``bmps``'s torch code,
one host read a pass) for CPU tensors. :func:`engages` says which inputs
``bmps.variational_implicit`` hands to K5: float32 on the card at the
shapes the kernel is built for.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the kernel's shapes: bonds (new and old) of 8; the physical, MPO and
# target legs of 16; at most 16 sites (a lane's environments stay in the
# block's shared memory)
BOND, LEG, MAX_SITES = 8, 16, 16


def polish_row_plain(A0, phi_A, Wc, *, tol, max_sweeps):
    """The polish in plain torch (``bmps.variational_implicit_plain``):
    A0 (B, L, Dn, du, Dn) left-canonical zip-up output, phi_A (B, L, Do,
    d, Do) the target MPS, Wc (B, L, l, d, r, u) the row's MPO oriented
    (``bmps._orient_mpo``). Returns (A, overlap (B,), ln_state (B,),
    sweeps (B,) int64)."""
    from .. import bmps
    return bmps.variational_implicit_plain(A0, phi_A, Wc, tol=tol,
                                           max_sweeps=max_sweeps)


def _shapes_fit(A0, phi_A, Wc):
    if A0.dim() != 5 or phi_A.dim() != 5 or Wc.dim() != 6:
        return False
    B, L = A0.shape[:2]
    return (1 <= L <= MAX_SITES
            and tuple(A0.shape[2:]) == (BOND, LEG, BOND)
            and tuple(phi_A.shape) == (B, L, BOND, LEG, BOND)
            and tuple(Wc.shape) == (B, L) + (LEG,) * 4)


def engages(A0, phi_A, Wc) -> bool:
    """Whether K5 takes these inputs: float32 CUDA tensors on one card at
    the kernel's shapes (bonds 8, legs 16, 1 <= L <= 16). Decided from
    the tensors alone, without a device read."""
    ts = (A0, phi_A, Wc)
    return (all(t.device.type == "cuda" and t.dtype == torch.float32
                for t in ts)
            and len({t.device for t in ts}) == 1 and _shapes_fit(*ts))


# the entry point's arguments: A0 and its five strides, phi and its five,
# W and its batch and site strides, B, L, tol, max_sweeps, the four
# outputs, the stream
_ARGS = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 5
         + (ctypes.c_void_p,) + (ctypes.c_longlong,) * 5
         + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int)
         + (ctypes.c_void_p,) * 5)


def polish_row(A0, phi_A, Wc, *, tol, max_sweeps):
    """The polish of one row: K5 on CUDA tensors (one launch, one block
    per lane, each lane sweeping to its own stop, no host read), the
    plain version on CPU tensors. See :func:`polish_row_plain`. Raises
    ValueError for any dtype, shape or device K5 does not take."""
    ts = (A0, phi_A, Wc)
    if all(t.device.type == "cpu" for t in ts):
        return polish_row_plain(A0, phi_A, Wc, tol=tol,
                                max_sweeps=max_sweeps)
    if not all(t.device.type == "cuda" for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError(f"polish_row: A0, phi_A and Wc must lie on one "
                         f"CUDA card, got {[str(t.device) for t in ts]}")
    if not all(t.dtype == torch.float32 for t in ts):
        raise ValueError(f"polish_row: K5 takes float32, got "
                         f"{[t.dtype for t in ts]}")
    if not _shapes_fit(*ts):
        raise ValueError(
            f"polish_row: K5 takes A0 (B, L, 8, 16, 8), phi_A (B, L, 8, 16, "
            f"8) and Wc (B, L, 16, 16, 16, 16) with 1 <= L <= "
            f"{MAX_SITES}, got {tuple(A0.shape)}, {tuple(phi_A.shape)}, "
            f"{tuple(Wc.shape)}")
    if Wc.stride()[2:] != (LEG ** 3, LEG ** 2, LEG, 1) \
            or Wc.stride(0) % 4 or Wc.stride(1) % 4 or Wc.data_ptr() % 16:
        # the kernel streams each site's W in 16-byte pieces
        Wc = Wc.contiguous()
    B, L = A0.shape[:2]
    dev = A0.device
    A = torch.empty((B, L, BOND, LEG, BOND), dtype=A0.dtype, device=dev)
    overlap = torch.empty((B,), dtype=A0.dtype, device=dev)
    ln_state = torch.empty((B,), dtype=A0.dtype, device=dev)
    sweeps = torch.empty((B,), dtype=torch.int64, device=dev)
    fn = build.fn("polish", "tnax_polish_f32", _ARGS)
    err = fn(A0.data_ptr(), *A0.stride(), phi_A.data_ptr(), *phi_A.stride(),
             Wc.data_ptr(), Wc.stride(0), Wc.stride(1), B, L, float(tol),
             int(max_sweeps), A.data_ptr(), overlap.data_ptr(),
             ln_state.data_ptr(), sweeps.data_ptr(), build.raw_stream(dev))
    build.check(build.load("polish"), err, "polish_row")
    polish_row.launches += 1
    return A, overlap, ln_state, sweeps


polish_row.launches = 0
