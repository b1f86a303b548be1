"""Profile one warm flagship search, sampling pass or spectrum of the port
(tnax_torch) on a CUDA card.

    python tools/profile_port.py [--dtype float32] \
        [--fleet | --sample | --spectrum] [--out PATH]

Runs the flagship search on the committed synthetic chimera-2048 instance
once cold (the kernels' nvcc builds, cuSOLVER/cuBLAS handles), once warm
without the profiler (its wall-clock), then once warm under
``torch.profiler`` with CPU and CUDA activities. With
``--fleet`` the search is one fleet batch instead: the 8 committed
chimera-512 instances through ``multi_flagship_search_gs`` at their
oracles' operating point (cand_factor=2). With ``--sample`` it is one
Gibbs sampling pass of the same 8 instances through
``multi_flagship_sample`` at the e02 point (128 walkers each, D=48,
pre_steps=2, beta=3, seed 1). With ``--spectrum`` it is the chimera-2048
low-energy spectrum at bench.py's point through the Solver
(``np.random.seed(7); add_noise(1e-7)``, ``precondition()``, ee=2,
M=1024, D=32, cutoff 1e-8, max_dEng=1.0, cand_factor=64 with auto_grow,
then the decode): its stages split the ladder, the boundary, the records
on the device and the replay on the host. Writes the stage times, the
wall time, the summed device-kernel time and the device's idle share,
the kernel launches, and the top operators by device time and by host
time, to ``--out``; prints the summary lines. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fleet", action="store_true",
                      help="profile one batch of the 8 chimera-512 "
                      "instances")
    mode.add_argument("--sample", action="store_true",
                      help="profile one sampling pass of the 8 chimera-512 "
                      "instances")
    mode.add_argument("--spectrum", action="store_true",
                      help="profile one chimera-2048 low-energy spectrum")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_port.txt"))
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("profile_port: needs a CUDA card")
    sys.path.insert(0, ROOT)
    import tnax_torch as tt

    data = os.path.join(ROOT, "tests", "data")
    bases = [os.path.join(data, f"chimera512_synth_s{s}") for s in
             range(1, 9)] if args.fleet or args.sample else \
        [os.path.join(data, "chimera2048_synth_s0")]
    with open(bases[0] + "_oracle.json") as f:
        oracle = json.load(f)
    Js = [tt.round_Jij(tt.Jij_f2p(tt.load_Jij(b + ".txt")), 1 / 75)
          for b in bases]
    dtype = getattr(torch, args.dtype)

    def spectrum(stages):
        import numpy as np
        ins = tt.Solver(mode="Ising", Nx=oracle["Nx"], Ny=oracle["Ny"],
                        Nc=oracle["Nc"], J=Js[0], beta=oracle["beta"],
                        device="cuda", dtype=dtype)
        np.random.seed(7)
        ins.add_noise(1e-7)
        ins.precondition(stage_times=stages)
        ins.search_low_energy_spectrum(
            excitations_encoding=2, M=1024, relative_P_cutoff=1e-8, Dmax=32,
            max_dEng=1.0, path="device", cand_factor=64, stage_times=stages)
        t0 = time.perf_counter()
        ins.decode_low_energy_states(max_dEng=1.0)
        stages["decode"] = time.perf_counter() - t0
        return ins

    def run(stages):
        if args.spectrum:
            return spectrum(stages)
        solvers = [tt.Solver(mode="Ising", Nx=oracle["Nx"], Ny=oracle["Ny"],
                             Nc=oracle["Nc"], J=J, beta=oracle["beta"],
                             device="cuda", dtype=dtype) for J in Js]
        if args.sample:
            return tt.multi_flagship_sample(solvers, M=128, Dmax=48,
                                            pre_steps=2, seed=1,
                                            stage_times=stages)
        return tt.parallel.multi_flagship_search_gs(
            solvers, M=oracle["M"],
            relative_P_cutoff=oracle["relative_P_cutoff"],
            Dmax=oracle["Dmax"], cand_factor=oracle.get("cand_factor", 8),
            stage_times=stages)

    run({})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run({})
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    stages = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs = run(stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator row's self device time repeats the
    # time of the kernels it launched
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.spectrum:
        what = "spectrum ee=2 M=1024 D=32 cand_factor=64"
        result = (f"{len(rs.energy)} states, lowest {rs.energy[0]:.6f}, "
                  f"degeneracy {rs.degeneracy}; passes (cand_factor, "
                  f"merge_overflow, count_max) {rs.spectrum_passes}")
    elif args.sample:
        what = "sampling M=128 D=48"
        result = "mean sampled energies " + " ".join(
            f"{r['energy'].mean():.6f}" for r in rs)
    else:
        what = f"M={oracle['M']} D={oracle['Dmax']}"
        result = ("energies " + " ".join(f"{r['energy']:.6f}" for r in rs)
                  + "; degeneracies "
                  + " ".join(str(r["degeneracy"]) for r in rs))
    lines = [
        f"device {torch.cuda.get_device_name(0)} ({smi}); "
        f"{len(Js)} x L{oracle['L']} {args.dtype} {what}",
        f"wall {wall:.3f} s (profiled); stages "
        + " ".join(f"{k}={v:.3f}" for k, v in stages.items()),
        f"device kernel time {device_us / 1e6:.3f} s; device idle share "
        f"{1 - device_us / 1e6 / wall:.3f} of the profiled wall; "
        f"{launches} kernel launches",
        f"warm wall without the profiler {wall_plain:.3f} s (idle share "
        f"{1 - device_us / 1e6 / wall_plain:.3f} against it)",
        result,
        "",
        "top operators by device time:",
        events.table(sort_by="self_device_time_total", row_limit=30),
        "top operators by host time:",
        events.table(sort_by="self_cpu_time_total", row_limit=30),
    ]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:5]))


if __name__ == "__main__":
    main()
