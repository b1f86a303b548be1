"""Comparison ``gs``: the ground states a window returned, against the
plain reference.

A sample of the answered instances, drawn from the run's seed, is judged
after the window. For each, the reference works everything out again
from the instance's couplings: the exact energy of the returned state
(``reference.energy``), and its own search of the same instance at the
configuration's operating point in float64 (``reference.gs_search``). The
numbers, each the worst over the sample:

- ``missing``: instances started in the window that got no answer;
- ``recheck_gap``: how far an energy the program reports (its search's,
  and its own re-check where the traffic makes one) lies from the exact
  energy of the state it returned;
- ``gs_excess``: how far the exact energy of the returned state lies
  above the reference's ground state, on the instances the reference
  settles. Where the configuration gives ``check.settle_factor`` f, an
  instance is settled when the reference finds the same energy at M and
  at f * M; where it does not, M is too narrow for the reference itself,
  which side's beam lands lower follows each side's boundary truncation,
  and neither energy is a ground truth to hold the other to;
- ``degeneracy_shortfall``: how many fewer ground states the program
  counts than the reference, where both found the same energy and the
  program reports its merge complete. The device search caps its merge
  candidates at ``cand_factor`` * M and flags an overflow
  (``merge_overflow`` > 0); its count is then a lower bound of what its
  beam held, and is not compared: on the device cells that is nearly
  every instance. A count above the reference's is not a fault: the
  reference's beam, without the program's gauge, can drop degenerate
  branches the program keeps;
- ``log2p_gap_median``, where the configuration gives it a limit: the
  median, over the sampled instances where both found the same energy, of
  how far the returned log2-probability lies from the reference's. It
  follows each side's boundary truncation (the program's gauged and
  sketched, the reference's neither): at chimera-512 with D=48 most
  instances agree to 1e-3 and a few differ by up to 0.3, so the median,
  not the widest gap, separates a sound run from one in lower precision;
  at chimera-2048 neither does, and it is not compared there.

Each is held to the limit of the same name in the configuration's
``check.limits``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.reference import energy, gs_search

NUMBERS = ("missing", "recheck_gap", "gs_excess", "degeneracy_shortfall",
           "log2p_gap_median")
SAME_ENERGY = 1e-9


def sample(answers, count, seed):
    """``count`` answers (all, if fewer) drawn from the run's seed."""
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 2 ** 32 + 1])
    if len(answers) <= count:
        return list(answers)
    pick = rng.choice(len(answers), size=count, replace=False)
    return [answers[i] for i in sorted(pick)]


def reference_search(cfg, rows, torch, device, dtype=None):
    """The reference's ground state of one instance at the
    configuration's operating point (float64 unless ``dtype``)."""
    inst, sv = cfg["instance"], cfg["solver"]
    coupl = energy.couplings(rows, 1 / inst["coupling_levels"])
    return coupl, gs_search.search(
        inst["cells"], coupl, beta=sv["beta"], Dmax=sv["Dmax"], M=sv["M"],
        relative_P_cutoff=sv["relative_P_cutoff"],
        dtype=dtype or torch.float64, device=device)


def settled(cfg, rows, ref, torch, device):
    """Whether the reference's ground state ``ref`` of the instance
    ``rows`` stands at ``check.settle_factor`` times the beam (True where
    the configuration gives no factor), and the wider search's energy."""
    factor = cfg["check"].get("settle_factor")
    if not factor:
        return True, None
    sv = cfg["solver"]
    _, wide = reference_search(dict(cfg, solver=dict(sv, M=sv["M"] * factor)),
                               rows, torch, device)
    return abs(wide.energy - ref.energy) <= SAME_ENERGY, wide.energy


def compare(cfg, pool, started, answers, seed, torch, device, log=print,
            refs=None):
    """[(name, value, limit)] for the window's ``answers`` to the pool's
    instances ``started``; ``refs``, a dict, keeps the reference's
    results by instance for another comparison of the same pool."""
    refs = {} if refs is None else refs
    limits = cfg["check"]["limits"]
    got = {a.k for a in answers}
    worst = dict(missing=float(len(set(started) - got)), recheck_gap=0.0,
                 gs_excess=-np.inf, degeneracy_shortfall=0.0)
    log2p_gaps, unsettled = [], 0
    for a in sample(answers, cfg["check"]["instances_per_run"], seed):
        t0 = time.perf_counter()
        if a.k not in refs:
            coupl, ref = reference_search(cfg, pool[a.k], torch, device)
            refs[a.k] = (coupl, ref) + settled(cfg, pool[a.k], ref, torch,
                                               device)
        coupl, ref, sure, wide = refs[a.k]
        e_state = float(energy.energies(coupl, a.bits)[0])
        reported = [a.energy] + ([a.recheck] if a.recheck is not None else [])
        worst["recheck_gap"] = max(worst["recheck_gap"],
                                   *(abs(e - e_state) for e in reported))
        if sure:
            worst["gs_excess"] = max(worst["gs_excess"],
                                     e_state - ref.energy)
        else:
            unsettled += 1
        if abs(e_state - ref.energy) <= SAME_ENERGY:
            if a.exact:
                worst["degeneracy_shortfall"] = max(
                    worst["degeneracy_shortfall"],
                    float(ref.degeneracy - a.degeneracy))
            log2p_gaps.append(abs(a.log2p - ref.log2p))
        log(f"checked instance {a.k}: program E {a.energy!r} deg "
            f"{a.degeneracy} (exact {a.exact}) log2p {a.log2p!r}; state E "
            f"{e_state!r}; "
            f"reference E {ref.energy!r} deg {ref.degeneracy} log2p "
            f"{ref.log2p!r}"
            + ("" if wide is None else f"; at settle_factor * M E {wide!r}")
            + f"; reference {time.perf_counter() - t0:.3f} s")
    if not answers:
        worst["gs_excess"] = np.inf
    elif worst["gs_excess"] == -np.inf:     # no sampled instance settled
        worst["gs_excess"] = 0.0
    if unsettled:
        log(f"gs_excess: {unsettled} sampled instance(s) not settled by "
            f"the reference, not compared")
    worst["log2p_gap_median"] = float(np.median(log2p_gaps)) \
        if log2p_gaps else 0.0
    return [(name, float(worst[name]), float(limits[name]))
            for name in NUMBERS if name in limits]


def passed(numbers):
    return all(value <= limit for _, value, limit in numbers)
