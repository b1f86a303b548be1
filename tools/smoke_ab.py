#!/usr/bin/env python3
"""A/B of the search's kernels and of the search itself between checkouts
of the port, in turns, on one CUDA card.

    python tools/smoke_ab.py build/parent . build/parent

runs one turn per ROOT given, in that order, each in its own process with
ROOT first on ``sys.path`` (so the turn imports that checkout's
``tnax_torch`` and ``chip_smoke``). A turn
  1. builds the checkout's kernels (one nvcc per source, all at once);
  2. runs the checkout's own ``chip_smoke.kernel_checks`` (phase 2: every
     kernel against its plain version, with that checkout's timings);
  3. times K2 (merge_segments) at (1, 8192) and (8, 2048) and K3
     (marginal_epilogue) at (1, 1024, 256) and (8, 1024, 256), float32, on
     the same seeded inputs in every turn: one wrapper call (median of 20
     calls, CUDA events) and the device time alone (20 calls captured in
     one CUDA graph, per call);
  4. runs the chimera-2048 flagship search at cand_factor=8, float32 cold
     and three warm (``chip_smoke.slice_run``), and the fleet of 8
     chimera-512 instances, float32 cold and three warm
     (``chip_smoke.fleet_run``);
and prints one line ``AB {json}`` with the card, its power limit and these
numbers. Compare turns only within one run of this script: the card and
its neighbours change between runs.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 20


def _device_ms(fn, torch):
    """Device time of one call of ``fn``: REPS calls captured in one CUDA
    graph, replayed back to back (median of 5 replays), per call; None when
    the checkout's wrapper cannot be captured."""
    try:
        return _graph_ms(fn, torch)
    except RuntimeError as e:
        print(f"smoke_ab: no device-only time ({e})", flush=True)
        return None


def _graph_ms(fn, torch):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / REPS)
    return statistics.median(times)


def _kernel_times(cs, torch, dev):
    """K2 and K3 on the same seeded float32 inputs, through whichever
    interface the checkout has."""
    from tnax_torch import kernels
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    merge_kb = "key_bits" in inspect.signature(
        kernels.merge_segments).parameters
    for B, C, label in ((1, 8192, "B1"), (8, 2048, "B8")):
        key1 = (torch.randint(0, 3000 * C // 8192, (B, C), generator=gen)
                << 1).to(dev, torch.int32)
        valid = (torch.rand((B, C), generator=gen) < 0.9).to(dev)
        key1 = key1 | (~valid).to(torch.int32)
        Eng = (torch.randint(-300, 300, (B, C), generator=gen)
               / 75.0).to(dev, torch.float64)
        prob = (-torch.randn((B, C), generator=gen).abs() * 20).to(dev)
        deg = torch.randint(1, 1000, (B, C), generator=gen).to(dev)
        kw = dict(key_bits=13) if merge_kb else {}

        def k2():
            return kernels.merge_segments(key1, Eng, prob, valid, deg,
                                          1e-12, **kw)
        out[f"merge {label}"] = dict(ms=cs.median_ms(k2, torch),
                                     device_ms=_device_ms(k2, torch))
    new_k3 = "log2_cutoff" in inspect.signature(
        kernels.marginal_epilogue).parameters
    M, Np, lh, lv = 1024, 256, 16, 16
    for B, label in ((1, "B1"), (8, "B8")):
        T2 = torch.randn((B, M, lv * lh), generator=gen).abs().to(dev)
        lB = (-torch.randn((B, Np, lh, lv), generator=gen).abs() * 30).to(dev)
        drindex = torch.stack([torch.randperm(lv * lh, generator=gen)[:Np]
                               for _ in range(B)]).to(dev)
        lidx = torch.randint(0, lh, (B, M), generator=gen).to(dev)
        uidx = torch.randint(0, lv, (B, M), generator=gen).to(dev)
        nvalid = torch.full((B,), 200, device=dev)
        probv = (-torch.randn((B, M), generator=gen).abs() * 50).to(dev)
        bvalid = (torch.rand((B, M), generator=gen) < 0.8).to(dev)
        if new_k3:
            args = (T2, kernels.marginal.boltzmann_columns(lB), drindex,
                    lidx, uidx, nvalid, probv, bvalid, -26.575424759098897)
        else:
            args = (T2, lB, drindex, lidx, uidx, nvalid, probv, bvalid)

        def k3():
            return kernels.marginal_epilogue(*args)
        out[f"marginal_epilogue {label}"] = dict(
            ms=cs.median_ms(k3, torch), device_ms=_device_ms(k3, torch))
    return out


def turn(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    import tnax_torch as tt
    from concurrent.futures import ThreadPoolExecutor
    from tnax_torch.kernels import build
    if not torch.cuda.is_available():
        sys.exit("smoke_ab: needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    names = sorted(f[:-3] for f in os.listdir(build.CSRC)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))
    res = dict(root=root, card=smi)
    floor = cs.launch_floor_ms(torch, dev)
    res["launch_floor_ms"] = floor
    params = inspect.signature(cs.kernel_checks).parameters
    kres = cs.kernel_checks(tt, torch, dev, *([floor] if "floor" in params
                                              else []))
    res["phase2"] = {k: {name: {label: {f: r[f] for f in ("ms", "plain_ms",
                                                         "bound_ms")
                                        if f in r}
                                for label, r in cases.items()}
                         for name, cases in v.items()}
                     for k, v in kres.items() if k in ("merge",
                                                       "marginal_epilogue")}
    res["kernels"] = _kernel_times(cs, torch, dev)
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(cs.INSTANCE)), 1 / 75)
    with open(cs.ORACLE) as f:
        oracle = json.load(f)
    search = [cs.slice_run(tt, torch, J, oracle, torch.float32, label)
              for label in ("f32 cold", "f32 warm 1", "f32 warm 2",
                            "f32 warm 3")]
    res["search_s"] = [r[0] for r in search]
    res["search_stages"] = [r[1] for r in search]
    Js, oracles = [], []
    for base in cs.FLEET:
        Js.append(tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")),
                               1 / 75))
        with open(base + "_oracle.json") as f:
            oracles.append(json.load(f))
    fleet = [cs.fleet_run(tt, torch, Js, oracles, torch.float32, label)
             for label in ("f32 cold", "f32 warm 1", "f32 warm 2",
                           "f32 warm 3")]
    res["fleet_s"] = [r[0] for r in fleet]
    res["fleet_stages"] = [r[1] for r in fleet]
    print("AB " + json.dumps(res), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    t0 = time.perf_counter()
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                        root], check=True)
        print(f"smoke_ab: turn {root} done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
