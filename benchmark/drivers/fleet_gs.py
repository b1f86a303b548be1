"""Driver ``fleet_gs``: e07's fleet sweep, one batch a unit.

One Solver per instance of the batch, one
``parallel.multi_flagship_search_gs`` over them with the traffic's
``cand_factor``, then the exact energy of each returned state, as e07
re-checks it.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.answers import Answer
from benchmark.harness.drivers import solver


def run(tt, cfg, params, unit, device, dtype, stage_times=None):
    """The answers of one batch: ``unit`` is [(k, rows), ...]; an
    instance the program does not answer gets no answer."""
    sv = cfg["solver"]
    Js, solvers = zip(*(solver(tt, cfg, rows, device, dtype)
                        for _, rows in unit))
    results = tt.parallel.multi_flagship_search_gs(
        solvers, M=sv["M"], relative_P_cutoff=sv["relative_P_cutoff"],
        Dmax=sv["Dmax"], cand_factor=params["cand_factor"],
        stage_times=stage_times)
    answers = []
    for (k, _), J, ins, r in zip(unit, Js, solvers, results):
        ins.states = np.asarray(r["states"])[None, :][:, ins.order]
        bits = ins.binary_states()
        answers.append(Answer(k, float(r["energy"]), bits[0],
                              int(r["degeneracy"]), float(r["prob"]),
                              float(tt.energy_Jij(J, bits)[0]),
                              exact=int(r["merge_overflow"]) == 0))
    return answers

