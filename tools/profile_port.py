"""Profile one warm flagship search of the port (tnax_torch) on a CUDA card.

    python tools/profile_port.py [--dtype float32] \
        [--out chiprun_out/profile_port.txt]

Runs the flagship search on the committed synthetic chimera-2048 instance
once cold (kernel builds, cuSOLVER/cuBLAS handles, Triton compile), then
once warm under ``torch.profiler`` with CPU and CUDA activities. Writes the
stage times, the wall time, the summed device-kernel time and the
device's idle share, and the top operators by device time and by host
time, to ``--out``; prints the summary lines. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
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

    base = os.path.join(ROOT, "tests", "data", "chimera2048_synth_s0")
    with open(base + "_oracle.json") as f:
        oracle = json.load(f)
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")), 1 / 75)
    dtype = getattr(torch, args.dtype)

    def run(stages):
        ins = tt.Solver(mode="Ising", Nx=oracle["Nx"], Ny=oracle["Ny"],
                        Nc=oracle["Nc"], J=J, beta=oracle["beta"],
                        device="cuda", dtype=dtype)
        return tt.parallel.flagship_search_gs(
            ins, M=oracle["M"], relative_P_cutoff=oracle["relative_P_cutoff"],
            Dmax=oracle["Dmax"], stage_times=stages)

    run({})
    torch.cuda.synchronize()
    stages = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator row's self device time repeats the
    # time of the kernels it launched
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    lines = [
        f"device {torch.cuda.get_device_name(0)}; L2048 {args.dtype} "
        f"M={oracle['M']} D={oracle['Dmax']}",
        f"wall {wall:.3f} s (profiled); stages "
        + " ".join(f"{k}={v:.3f}" for k, v in stages.items()),
        f"device kernel time {device_us / 1e6:.3f} s; device idle share "
        f"{1 - device_us / 1e6 / wall:.3f}; {launches} kernel launches",
        f"energy {res['energy']:.6f} deg {res['degeneracy']}",
        "",
        "top operators by device time:",
        events.table(sort_by="self_device_time_total", row_limit=30),
        "top operators by host time:",
        events.table(sort_by="self_cpu_time_total", row_limit=30),
    ]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:4]))


if __name__ == "__main__":
    main()
