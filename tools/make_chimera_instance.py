"""Seeded synthetic chimera spin-glass instance and its tnax oracle.

Writes a chimera C(n) instance in the droplet-instance text format: one
``i j Jij`` line per coupling, 1-based spin indices, no fields. The lattice
is n x n K4,4 cells of 8 spins; spin ``m`` of cell (ny, nx) has index
``8 * (n * ny + nx) + m`` (tnax's block convention). Inside a cell every
spin k < 4 couples to every spin k' >= 4; spin k < 4 couples to the same k
in the cell below, spin k >= 4 to the same k in the cell to the right.
Couplings are nonzero integer multiples of 1/75 in [-1, 1], drawn with
numpy's default_rng(seed).

    python tools/make_chimera_instance.py --L 2048 --seed 0 \
        --out tests/data/chimera2048_synth_s0.txt

``--oracle`` also runs tnax's ``flagship_search_gs`` on the written file
in float64 on the CPU at the flagship point (M=1024, D=32,
relative_P_cutoff=1e-8) and writes ``<out stem>_oracle.json`` beside it:
the exact ``energy_Jij`` energy of the returned state, its degeneracy,
block states, the parameters, the wall-clock and the tnax commit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SIDES = {128: 4, 512: 8, 1152: 12, 2048: 16}
M, DMAX, CUTOFF = 1024, 32, 1e-8   # the flagship operating point


def chimera_couplings(n: int, seed: int):
    """[(i, j, Jij)] with 0-based i < j for chimera C(n)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for ny in range(n):
        for nx in range(n):
            base = 8 * (n * ny + nx)
            for a in range(4):
                for b in range(4, 8):
                    pairs.append((base + a, base + b))
            if ny + 1 < n:
                below = 8 * (n * (ny + 1) + nx)
                for k in range(4):
                    pairs.append((base + k, below + k))
            if nx + 1 < n:
                right = 8 * (n * ny + nx + 1)
                for k in range(4, 8):
                    pairs.append((base + k, right + k))
    mag = rng.integers(1, 76, size=len(pairs))
    sign = rng.choice(np.array([-1, 1]), size=len(pairs))
    return [(i, j, int(s * m) / 75.0)
            for (i, j), s, m in zip(pairs, sign, mag)]


def write_instance(path: str, n: int, seed: int) -> None:
    with open(path, "w") as f:
        for i, j, v in chimera_couplings(n, seed):
            f.write(f"{i + 1} {j + 1} {v!r}\n")


def tnax_oracle(path: str, n: int) -> dict:
    """tnax flagship search on the instance, float64 on the CPU."""
    os.environ.setdefault("TNAX_PLATFORM", "cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("TNAX_X64", "1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import tnax
    from tnax import parallel

    J = tnax.round_Jij(tnax.Jij_f2p(tnax.load_Jij(path)), 1 / 75)
    ins = tnax.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, J=J, beta=3)
    t0 = time.time()
    res = parallel.flagship_search_gs(ins, M=M, relative_P_cutoff=CUTOFF,
                                      Dmax=DMAX, zipup_rsvd=True)
    seconds = time.time() - t0
    ins.states = np.asarray(res["states"])[None, :][:, ins.order]
    energy = float(tnax.energy_Jij(J, ins.binary_states())[0])
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                            capture_output=True, text=True).stdout.strip()
    return dict(
        instance=os.path.basename(path), L=8 * n * n, Nx=n, Ny=n, Nc=8,
        beta=3, M=M, Dmax=DMAX, relative_P_cutoff=CUTOFF, zipup_rsvd=True,
        dtype="float64", device="cpu", energy=energy,
        degeneracy=int(res["degeneracy"]),
        states=[int(s) for s in np.asarray(res["states"])],
        merge_overflow=int(res["merge_overflow"]),
        count_max=int(res["count_max"]),
        cold_seconds=round(seconds, 2), tnax_commit=commit)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, required=True, choices=sorted(SIDES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--oracle", action="store_true")
    args = ap.parse_args()
    n = SIDES[args.L]
    write_instance(args.out, n, args.seed)
    if args.oracle:
        out = tnax_oracle(args.out, n)
        with open(os.path.splitext(args.out)[0] + "_oracle.json", "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(json.dumps({k: out[k] for k in ("energy", "degeneracy",
                                              "cold_seconds")}))


if __name__ == "__main__":
    main()
