"""K4: the Gibbs sampler's site step after its two GEMMs
(``tnax.engine.marginal_step``'s tail, the inverse-CDF draw of
``tnax.parallel.sample_rows``, the walker's writes, ``rl_update`` and the
row's minimum of mPn).

:func:`sample_site` launches the CUDA kernel in ``csrc/sample.cu`` for
CUDA tensors and runs :func:`sample_site_plain` for CPU tensors. The
Boltzmann columns are read from ``lBT`` (B, lh, lv, Np), the site's table
with the states last (``marginal.boltzmann_columns``), as K3 reads them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import engine
from . import build
from .marginal import _pn_from_columns, columns

NP_MAX = 4096   # above 512 states a warp holds its row in shared memory


def _draw(Pn, nvalid, u):
    """The inverse-CDF draw of tnax parallel.py:1295-1299: the number of
    cumulative sums of Pn (B, M, Np) below u (B, M), clipped to
    [0, nvalid - 1]; int32."""
    cums = torch.cumsum(Pn, dim=2)
    count = (cums < u[..., None]).sum(dim=2)
    top = nvalid.reshape(-1, 1).long() - 1
    return torch.minimum(torch.clamp(count, min=0), top).to(torch.int32)


def sample_draw_plain(T2, lBT, drindex, lidx, uidx, nvalid, u):
    """One draw per walker from its normalized conditional marginal.

    T2 (B, M, lv*lh), lBT (B, lh, lv, Np) the site's table with the states
    last, drindex (B, Np), lidx/uidx (B, M) and nvalid (B,) as in
    :func:`marginal.marginal_epilogue_plain`; u (B, M) uniforms in [0, 1)
    in the dtype of T2. With Pn the marginals, the drawn state is the
    number of cumulative sums of Pn below u, clipped to [0, nvalid - 1]
    (tnax parallel.py:1295-1299). Returns (indc (B, M) int32, mPn (B, M)).
    """
    Pn, mPn = _pn_from_columns(T2, columns(lBT, lidx, uidx), drindex,
                               nvalid)
    return _draw(Pn, nvalid, u), mPn


def draw_mismatches(got, want, args):
    """Compare K4's draws ``got`` with the plain version's ``want`` (both
    (B, M)) on the inputs ``args`` of :func:`sample_draw_plain`. Returns
    (the number of draws that differ, the number of those that rounding
    does not explain). The kernel's scan adds in another order than
    torch.cumsum, so a draw may differ only where the plain version's
    cumulative sums between the two drawn indices lie within 64 eps of
    the walker's uniform."""
    T2, lBT, drindex, lidx, uidx, nvalid, u = args
    cums = torch.cumsum(_pn_from_columns(T2, columns(lBT, lidx, uidx),
                                         drindex, nvalid)[0], dim=2)
    eps = torch.finfo(u.dtype).eps
    bad = (got != want).nonzero().tolist()
    unexplained = 0
    for b, m in bad:
        lo, hi = sorted((int(got[b, m]), int(want[b, m])))
        near = (cums[b, m, lo:hi] - u[b, m]).abs() <= 64 * eps
        unexplained += not bool(near.all())
    return len(bad), unexplained


def sample_site_plain(T2, lBT, drindex, dmap, rmap, nvalid, u, AT, RL, vind,
                      states, nx, col, mq):
    """One site of the sampling pass for the M walkers of B instances,
    after the two GEMMs.

    T2 (B, M, lv*lh) per-walker products, lBT (B, lh, lv, Np) the site's
    log-Boltzmann table with the states last, drindex (B, Np), dmap/rmap
    (B, Np) the drawn state's down and right leg values, nvalid (B,) in
    1..Np, u (B, M) uniforms in [0, 1), AT (B, D, lv, D) the boundary
    site, RL (B, M, D) the walkers' left environments, vind (B, M, Nx+1)
    and states (B, M, L) the walkers (int32), nx the site's column and col
    its index in ``states``, mq (B,) the row's running minimum of mPn.

    Walker (b, m) reads its leg values lidx = vind[b, m, nx] and
    uidx = vind[b, m, nx+1], draws indc from its marginals
    (:func:`sample_draw_plain` on its column), and writes
    states[b, m, col] = indc, vind[b, m, nx] = dmap[b, indc] and
    vind[b, m, nx+1] = rmap[b, indc]; mq takes the minimum of itself and
    the site's mPn. vind, states and mq are updated in place. Returns
    (RL' (B, M, D), ``engine.rl_update`` through the drawn down legs, a
    new tensor; mPn (B, M)).
    """
    indc, mPn = sample_draw_plain(T2, lBT, drindex, vind[:, :, nx],
                                  vind[:, :, nx + 1], nvalid, u)
    ind = indc.long()
    states[:, :, col] = indc.to(states.dtype)
    vind[:, :, nx] = dmap.gather(1, ind).to(vind.dtype)
    vind[:, :, nx + 1] = rmap.gather(1, ind).to(vind.dtype)
    mq.copy_(torch.minimum(mq, mPn.amin(dim=1)))
    return engine.rl_update(RL, AT, vind[:, :, nx]), mPn


# the entry points' arguments: T2, then lBT, drindex, dmap, rmap, nvalid,
# u and AT (pointer, batch stride each), RL, vind, states, RL', mPn, mq,
# B, M, Np, lv, lh*lv, D, Nx+1, L, nx, col, the stream
_ARGS = ((ctypes.c_void_p,) + (ctypes.c_void_p, ctypes.c_longlong) * 7
         + (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 10 + (ctypes.c_void_p,))


def sample_site(T2, lBT, drindex, dmap, rmap, nvalid, u, AT, RL, vind,
                states, nx, col, mq):
    """One site of the sampling pass; the CUDA kernel on CUDA tensors (one
    launch for all B instances, one warp per walker), the plain version on
    CPU tensors. See :func:`sample_site_plain`. On the card the indices are
    read as the sampler holds them: drindex and nvalid int64, dmap, rmap,
    vind and states int32; the per-site slices of the pass's stacks are
    read in place (each instance's block contiguous), and vind, states and
    mq must be contiguous."""
    if T2.device.type == "cpu":
        return sample_site_plain(T2, lBT, drindex, dmap, rmap, nvalid, u, AT,
                                 RL, vind, states, nx, col, mq)
    if T2.device.type != "cuda":
        raise ValueError(f"sample_site: unsupported device {T2.device}")
    B, M = T2.shape[:2]
    lh, lv, Np = lBT.shape[1:]
    D = RL.shape[2]
    W, L = vind.shape[2], states.shape[2]
    dtype, dev = T2.dtype, T2.device
    if dtype not in (torch.float32, torch.float64) or any(
            t.dtype != dtype for t in (lBT, u, AT, RL, mq)):
        raise ValueError(f"sample_site: T2, lBT, u, AT, RL and mq must share "
                         f"float32 or float64, got "
                         f"{[str(t.dtype) for t in (T2, lBT, u, AT, RL, mq)]}")
    for name, t, dt in (("drindex", drindex, torch.int64),
                        ("nvalid", nvalid, torch.int64),
                        ("dmap", dmap, torch.int32),
                        ("rmap", rmap, torch.int32),
                        ("vind", vind, torch.int32),
                        ("states", states, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"sample_site: {name} must be {dt}, got "
                             f"{t.dtype}")
    if T2.shape != (B, M, lh * lv) or lBT.shape[0] != B or \
            drindex.shape != (B, Np) or dmap.shape != (B, Np) or \
            rmap.shape != (B, Np) or nvalid.shape != (B,) or \
            u.shape != (B, M) or AT.shape != (B, D, lv, D) or \
            RL.shape != (B, M, D) or vind.shape[:2] != (B, M) or \
            states.shape[:2] != (B, M) or mq.shape != (B,) or \
            not 0 <= nx < W - 1 or not 0 <= col < L:
        raise ValueError("sample_site: inconsistent shapes")
    if not 1 <= Np <= NP_MAX:
        raise ValueError(f"sample_site: the kernel takes 1..{NP_MAX} states, "
                         f"got {Np}")
    ins = (lBT, drindex, dmap, rmap, nvalid, u, AT, RL, vind, states, mq)
    if any(t.device != dev for t in ins):
        raise ValueError(f"sample_site: all inputs must lie on {dev}")
    if not (vind.is_contiguous() and states.is_contiguous()
            and mq.is_contiguous()):
        raise ValueError("sample_site: vind, states and mq are written in "
                         "place and must be contiguous")
    # one instance's block of each input contiguous; the instances may lie
    # apart (the per-site slices of the pass's stacks)
    T2, RL = T2.contiguous(), RL.contiguous()
    if lBT.stride()[1:] != (lv * Np, Np, 1):
        lBT = lBT.contiguous()
    if AT.stride()[1:] != (lv * D, D, 1):
        AT = AT.contiguous()
    drindex, dmap, rmap, u = (t if t.stride(1) == 1 else t.contiguous()
                              for t in (drindex, dmap, rmap, u))
    # RL' and mPn in one allocation
    out = torch.empty(B * M * (D + 1), dtype=dtype, device=dev)
    RLn = out[:B * M * D].view(B, M, D)
    mPn = out[B * M * D:].view(B, M)
    fn = build.fn("sample", "tnax_sample_site_f64" if dtype == torch.float64
                  else "tnax_sample_site_f32", _ARGS)
    err = fn(T2.data_ptr(),
             *(x for t in (lBT, drindex, dmap, rmap, nvalid, u, AT)
               for x in (t.data_ptr(), t.stride(0))),
             *(t.data_ptr() for t in (RL, vind, states, RLn, mPn, mq)),
             B, M, Np, lv, lh * lv, D, W, L, int(nx), int(col),
             build.raw_stream(dev))
    build.check(build.load("sample"), err, "sample_site")
    sample_site.launches += 1
    return RLn, mPn


sample_site.launches = 0
