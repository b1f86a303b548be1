"""Gibbs sampling from the PEPS-represented Boltzmann distribution, with
the host's random numbers (the ``path="host"`` default of
``Solver.gibbs_sampling``).

Counterpart of ``tnax/sample.py``: each of M walkers draws its block
state site by site from its conditional distribution (reference
`gibbs_sampling`, `tnac4o/tnac4o.py:553-650`). tnax draws on the host
from a NumPy generator, ``rng.random(M)`` per site, rows then columns;
here the same numbers are drawn up front, in the same order, and the pass
runs on the device with them (``parallel.multi_sample``, kernel K4 for
each site step on CUDA), so a seeded generator gives tnax's samples up
to draws within rounding of a boundary of the cumulative distribution.
Energies are replayed exactly in float64 on the host.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from . import config, parallel

logger = logging.getLogger("tnax_torch")


@dataclasses.dataclass
class SampleResult:
    energy: np.ndarray
    states: np.ndarray
    negative_probability: float


def gibbs_sampling(ctx, M=2 ** 10, Dmax=32, tolS=1e-15, tolV=1e-10,
                   max_sweeps=20, graduate_truncation=True, rng=None,
                   omega=None, stage_times=None) -> SampleResult:
    """M samples of the one instance of ``ctx`` (tnax's
    ``gibbs_sampling``): the boundary stack at ``Dmax``, then the
    sampling pass on uniforms from ``rng`` (a NumPy Generator; None: a
    fresh ``np.random.default_rng()``, as in tnax), drawn in tnax's order.
    ``omega`` is the zip-up's sketch; ``stage_times``, if a dict,
    receives the seconds of the boundary and of the pass."""
    with config.StageClock(stage_times, ctx.device) as clock:
        t_total = time.time()
        logger.info("Preprocessing boundary MPS (D=%d) ...", Dmax)
        ctx.build_boundary(Dmax, tolS, tolV, max_sweeps, graduate_truncation,
                           omega=omega)
        clock.lap("boundary")
    logger.info("Elapsed: %.2f s", time.time() - t_total)
    rng = np.random.default_rng() if rng is None else rng
    u = np.stack([rng.random(M) for _ in range(ctx.Ny * ctx.Nx)])
    r = parallel.device_sample(
        ctx, M=M, Dmax=Dmax, uniforms=u.reshape(ctx.Ny, ctx.Nx, M),
        stage_times=stage_times)
    logger.info("Sampling total: %.2f s", time.time() - t_total)
    return SampleResult(energy=r["energy"], states=r["states"],
                        negative_probability=r["negative_probability"])
