"""tnax's low-energy spectrum of the committed chimera-128 instance, the
oracle of the port's spectrum on the card.

    python tools/make_spectrum_oracle.py

Runs tnax (float64 on the CPU) through its Solver on
``tests/data/chimera128_synth_s0.txt`` at the point of ``chip_smoke.py``'s
spectrum parity phase: beta=3, M=1024, D=16, relative cutoff 1e-8,
max_dEng=1.0, the exact-SVD zip-up (``zipup_rsvd=False``, so no sketch
enters), no preconditioning, ``path="device"`` with auto_grow from
cand_factor 8; once with excitations encoding 1, once with encoding 2
after ``np.random.seed(7); add_noise(1e-7)``. Writes
``tests/data/chimera128_synth_s0_spectrum_oracle.json``: per run the
parameters, the passes auto_grow took (cand_factor, merge_overflow,
count_max), the decoded energies and block states (cluster order), the
degeneracy, the seconds, and tnax's commit. About 15 s a run.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCE = os.path.join(ROOT, "tests", "data", "chimera128_synth_s0.txt")
OUT = os.path.join(ROOT, "tests", "data",
                   "chimera128_synth_s0_spectrum_oracle.json")
POINT = dict(M=1024, Dmax=16, relative_P_cutoff=1e-8, max_dEng=1.0,
             zipup_rsvd=False)
NOISE_SEED, NOISE = 7, 1e-7


def run(tnax, ee):
    from tnax import spectrum
    passes = []
    search = spectrum.device_search_spectrum

    def watched(*a, **kw):
        r = search(*a, **kw)
        passes.append([kw["cand_factor"], int(r.merge_overflow),
                       int(r.count_max)])
        return r
    spectrum.device_search_spectrum = watched
    try:
        J = tnax.round_Jij(tnax.Jij_f2p(tnax.load_Jij(INSTANCE)), 1 / 75)
        ins = tnax.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=3)
        if ee > 1:
            np.random.seed(NOISE_SEED)
            ins.add_noise(NOISE)
        t0 = time.time()
        ins.search_low_energy_spectrum(excitations_encoding=ee,
                                       path="device", **POINT)
        ins.decode_low_energy_states(max_dEng=POINT["max_dEng"])
        seconds = time.time() - t0
    finally:
        spectrum.device_search_spectrum = search
    return dict(excitations_encoding=ee,
                noise=dict(seed=NOISE_SEED, amplitude=NOISE) if ee > 1
                else None,
                passes=passes, cand_factor=passes[-1][0],
                merge_overflow=int(ins.merge_overflow),
                n_states=len(ins.energy), degeneracy=int(ins.degeneracy),
                energies=[float(e) for e in ins.energy],
                states=[[int(s) for s in st] for st in ins.states],
                seconds=round(seconds, 2))


def main():
    os.environ.setdefault("TNAX_PLATFORM", "cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("TNAX_X64", "1")
    sys.path.insert(0, ROOT)
    import tnax
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = dict(instance=os.path.basename(INSTANCE), L=128, Nx=4, Ny=4, Nc=8,
               beta=3, **POINT, path="device", auto_grow=True,
               initial_cand_factor=8, dtype="float64", device="cpu",
               runs=[run(tnax, ee) for ee in (1, 2)], tnax_commit=commit)
    text = json.dumps(out, indent=1)
    # one line per state and one for the energies
    text = re.sub(r"\[\s+([-0-9.e,\s]+?)\s+\]",
                  lambda m: "[" + " ".join(m.group(1).split()) + "]", text)
    with open(OUT, "w") as f:
        f.write(text + "\n")
    for r in out["runs"]:
        print(json.dumps({k: r[k] for k in ("excitations_encoding", "passes",
                                            "n_states", "degeneracy",
                                            "seconds")}))


if __name__ == "__main__":
    main()
