"""Driver ``solver_gs``: e01's ground-state search, one instance a unit.

One Solver per instance, ``precondition(mode="balancing")`` when the
configuration asks for it, then ``search_ground_state`` on the traffic's
``path``.
"""

from __future__ import annotations

from benchmark.harness.answers import Answer
from benchmark.harness.drivers import solver


def run(tt, cfg, params, unit, device, dtype, stage_times=None):
    """The answer of one instance: ``unit`` is [(k, rows)]."""
    (k, rows), = unit
    sv = cfg["solver"]
    _, ins = solver(tt, cfg, rows, device, dtype)
    if sv["precondition"]:
        ins.precondition(mode="balancing", stage_times=stage_times)
    ins.search_ground_state(M=sv["M"],
                            relative_P_cutoff=sv["relative_P_cutoff"],
                            Dmax=sv["Dmax"], path=params["path"],
                            stage_times=stage_times)
    return [Answer(k, float(ins.energy[0]), ins.binary_states()[0],
                   int(ins.degeneracy), float(ins.probability[0]),
                   exact=int(ins.merge_overflow) == 0)]

