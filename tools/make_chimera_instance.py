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
relative_P_cutoff=1e-8, beta=3; merge cap ``--cand-factor`` * M, tnax's
default 8 unless given) and writes ``<out stem>_oracle.json`` beside it:
the exact ``energy_Jij`` energy of the returned state, its degeneracy,
block states, the parameters, the wall-clock and the tnax commit. The
fleet instances use the fleet's operating point:

    python tools/make_chimera_instance.py --L 512 --seed 1 \
        --out tests/data/chimera512_synth_s1.txt --oracle --cand-factor 2

``--cand-factor 0`` is the full M*Np expansion (tnax's ``cand_factor=None``,
the uncapped exact merge); its oracle goes to ``<out stem>_full_oracle.json``:

    python tools/make_chimera_instance.py --L 2048 --seed 0 \
        --out tests/data/chimera2048_synth_s0.txt --oracle --cand-factor 0

``--sample-oracle`` runs tnax's ``flagship_sample`` instead, in float64 on
the CPU at the e02 sampling point (M=1024 walkers, D=48, pre_steps=2,
beta=3, seed 0, the zip-up sketch on), and writes
``<out stem>_sample_oracle.json``: the mean, standard deviation and
minimum of the sampled energies, their number N, the negative
probability and the command:

    python tools/make_chimera_instance.py --L 512 --seed 1 \
        --out tests/data/chimera512_synth_s1.txt --sample-oracle
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
SAMPLE_DMAX, SAMPLE_PRE_STEPS = 48, 2   # the e02 sampling point


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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tnax_solver(path: str, n: int):
    """tnax (float64 on the CPU) and its Solver on the instance."""
    os.environ.setdefault("TNAX_PLATFORM", "cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("TNAX_X64", "1")
    sys.path.insert(0, ROOT)
    import tnax

    J = tnax.round_Jij(tnax.Jij_f2p(tnax.load_Jij(path)), 1 / 75)
    return tnax, J, tnax.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, J=J, beta=3)


def _commit() -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                          capture_output=True, text=True).stdout.strip()


def tnax_oracle(path: str, n: int, cand_factor: int | None = 8) -> dict:
    """tnax flagship search on the instance, float64 on the CPU;
    ``cand_factor=None`` is the full expansion."""
    tnax, J, ins = _tnax_solver(path, n)
    from tnax import parallel
    t0 = time.time()
    res = parallel.flagship_search_gs(ins, M=M, relative_P_cutoff=CUTOFF,
                                      Dmax=DMAX, cand_factor=cand_factor,
                                      zipup_rsvd=True)
    seconds = time.time() - t0
    ins.states = np.asarray(res["states"])[None, :][:, ins.order]
    energy = float(tnax.energy_Jij(J, ins.binary_states())[0])
    return dict(
        instance=os.path.basename(path), L=8 * n * n, Nx=n, Ny=n, Nc=8,
        beta=3, M=M, Dmax=DMAX, relative_P_cutoff=CUTOFF,
        cand_factor=cand_factor, zipup_rsvd=True,
        dtype="float64", device="cpu", energy=energy,
        degeneracy=int(res["degeneracy"]),
        states=[int(s) for s in np.asarray(res["states"])],
        merge_overflow=int(res["merge_overflow"]),
        count_max=int(res["count_max"]),
        cold_seconds=round(seconds, 2), tnax_commit=_commit())


def tnax_sample_oracle(path: str, n: int, command: str) -> dict:
    """tnax flagship Gibbs sampling on the instance, float64 on the CPU;
    every sampled energy is checked against ``energy_Jij`` of its state."""
    os.environ["TNAX_ZIPUP_RSVD"] = "1"
    tnax, J, ins = _tnax_solver(path, n)
    from tnax import parallel
    t0 = time.time()
    res = parallel.flagship_sample(ins, M=M, Dmax=SAMPLE_DMAX, seed=0,
                                   pre_steps=SAMPLE_PRE_STEPS,
                                   zipup_rsvd=True)
    seconds = time.time() - t0
    E = np.asarray(res["energy"], dtype=np.float64)
    ins.states = np.asarray(res["states"])[:, ins.order]
    assert np.allclose(E, tnax.energy_Jij(J, ins.binary_states()),
                       atol=1e-9), "sampled energies disagree with energy_Jij"
    return dict(
        instance=os.path.basename(path), L=8 * n * n, Nx=n, Ny=n, Nc=8,
        beta=3, M=M, Dmax=SAMPLE_DMAX, pre_steps=SAMPLE_PRE_STEPS, seed=0,
        zipup_rsvd=True, dtype="float64", device="cpu", N=int(E.size),
        mean=float(E.mean()), std=float(E.std(ddof=1)), min=float(E.min()),
        negative_probability=float(res["negative_probability"]),
        cold_seconds=round(seconds, 2), command=command,
        tnax_commit=_commit())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, required=True, choices=sorted(SIDES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--sample-oracle", action="store_true",
                    help="tnax Gibbs sampling at the e02 point instead")
    ap.add_argument("--cand-factor", type=int, default=8,
                    help="merge cap of the oracle search, in units of M; "
                    "0 is the full expansion (tnax's cand_factor=None)")
    args = ap.parse_args()
    n = SIDES[args.L]
    write_instance(args.out, n, args.seed)
    if args.sample_oracle:
        command = "python tools/make_chimera_instance.py " + " ".join(
            sys.argv[1:])
        out = tnax_sample_oracle(args.out, n, command)
        with open(os.path.splitext(args.out)[0] + "_sample_oracle.json",
                  "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(json.dumps({k: out[k] for k in ("mean", "std", "min", "N",
                                              "cold_seconds")}))
    if args.oracle:
        full = args.cand_factor == 0
        out = tnax_oracle(args.out, n, None if full else args.cand_factor)
        suffix = "_full_oracle.json" if full else "_oracle.json"
        with open(os.path.splitext(args.out)[0] + suffix, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(json.dumps({k: out[k] for k in ("energy", "degeneracy",
                                              "merge_overflow", "count_max",
                                              "cold_seconds")}))


if __name__ == "__main__":
    main()
