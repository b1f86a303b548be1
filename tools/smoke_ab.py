#!/usr/bin/env python3
"""A/B of the port's kernels and of its end-to-end paths between checkouts
of the port, in turns, on one CUDA card.

    python tools/smoke_ab.py build/parent . build/parent
    python tools/smoke_ab.py --kernels build/parent . . build/parent

runs one turn per ROOT given, in that order, each in its own process with
ROOT first on ``sys.path`` (so the turn imports that checkout's
``tnax_torch`` and ``chip_smoke``). A turn
  1. builds the checkout's kernels (one nvcc per source, all at once);
  2. runs the checkout's own ``chip_smoke.kernel_checks`` (phase 2: every
     kernel against its plain version, with that checkout's timings);
  3. times K1 (gebal_scale) at 15 and 56 matrices of 16 x 16 and at 15
     badly balanced ones (chip_smoke's extreme case), K2
     (merge_segments) at (1, 8192) and (8, 2048), K3 (marginal_epilogue)
     at (1, 1024, 256) and (8, 1024, 256), and K4 at (1, 1024, 256) with
     D = 48 (``sample_draw`` where the checkout has it, else
     ``sample_site``), float32, on the same seeded inputs in every turn:
     one wrapper call (median of 20 calls, CUDA events) and the device
     time alone (20 calls captured in one CUDA graph, per call); and the
     sampler's whole site tail after the GEMMs on the same inputs (K4
     ``sample_site``, or ``sample_draw`` with the eager writes,
     ``rl_update`` and minimum around it);
  4. runs the chimera-2048 flagship search at cand_factor=8, float32 cold
     and three warm (``chip_smoke.slice_run``), the fleet of 8 chimera-512
     instances, float32 cold and three warm (``chip_smoke.fleet_run``),
     the e02 sampling pass of that fleet (128 walkers) and the
     chimera-2048 sampling pass (1024 walkers), float32 cold and three
     warm each (``chip_smoke.sample_run``);
and prints one line ``AB {json}`` with the card, its power limit and these
numbers. With ``--kernels`` a turn runs steps 1 and 3 alone. Compare turns
only within one run of this script: the card and its neighbours change
between runs.
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
    """K1-K4 on the same seeded float32 inputs, through whichever
    interface the checkout has."""
    from tnax_torch import kernels
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    for nmat, label in ((15, "B1"), (56, "B8"), (15, "extreme")):
        nd = torch.full((nmat,), 16, dtype=torch.int32, device=dev)
        if label == "extreme":
            k = torch.randint(-25, 26, (nmat, 16), generator=gen)
            A = torch.randn((nmat, 16, 16), generator=gen) * torch.exp2(
                k[:, :, None] - k[:, None, :])
            A[:, 2, :] = 0.0
            A[:, :, 5] = 0.0
            A = A.to(dev)
            nd[::5] = 13
        else:
            A = (torch.randn((nmat, 16, 16), generator=gen) * torch.exp2(
                torch.randint(-20, 20, (nmat, 16, 1), generator=gen))).to(dev)

        def k1():
            return kernels.gebal_scale(A, nd, 32.0)
        out[f"gebal {label}"] = dict(ms=cs.median_ms(k1, torch),
                                     device_ms=_device_ms(k1, torch))
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
    out.update(_site_times(cs, torch, dev, gen))
    return out


def _site_times(cs, torch, dev, gen):
    """K4 and the sampler's site tail after the two GEMMs at chimera-2048's
    point: 1024 walkers, Np = 256, lh = lv = 16, D = 48."""
    from tnax_torch import engine, kernels
    B, M, Np, lh, lv, D, nx, col = 1, 1024, 256, 16, 16, 48, 5, 37
    T2 = torch.randn((B, M, lv * lh), generator=gen).abs().to(dev)
    lB = (-torch.randn((B, Np, lh, lv), generator=gen).abs() * 30).to(dev)
    drindex = torch.randperm(lv * lh, generator=gen)[:Np][None].to(dev)
    dmap, rmap = (torch.randint(0, 16, (B, Np), generator=gen,
                                dtype=torch.int32).to(dev) for _ in range(2))
    nvalid = torch.full((B,), 256, device=dev)
    u = torch.rand((B, M), generator=gen).to(dev)
    AT = torch.randn((B, D, lv, D), generator=gen).to(dev)
    RL = torch.randn((B, M, D), generator=gen).to(dev)
    vind = torch.randint(0, 16, (B, M, 17), generator=gen,
                         dtype=torch.int32).to(dev)
    states = torch.zeros((B, M, 256), dtype=torch.int32, device=dev)
    if hasattr(kernels, "sample_site"):
        lBT = kernels.marginal.boltzmann_columns(lB)
        mq = torch.full((B,), float("inf"), device=dev)

        def k4():
            return kernels.sample_site(T2, lBT, drindex, dmap, rmap, nvalid,
                                       u, AT, RL, vind, states, nx, col, mq)
        tail = k4
    else:
        def k4():
            return kernels.sample_draw(T2, lB, drindex, vind[:, :, nx],
                                       vind[:, :, nx + 1], nvalid, u)

        def tail():
            # the parent's sample_rows after the GEMMs
            indc, mPn = k4()
            ind = indc.long()
            states[:, :, col] = indc.to(states.dtype)
            vind[:, :, nx] = dmap.gather(1, ind).to(vind.dtype)
            vind[:, :, nx + 1] = rmap.gather(1, ind).to(vind.dtype)
            return engine.rl_update(RL, AT, vind[:, :, nx]), mPn.amin(dim=1)
    return {"K4 B1_M1024": dict(ms=cs.median_ms(k4, torch),
                                device_ms=_device_ms(k4, torch)),
            "site tail B1_M1024": dict(ms=cs.median_ms(tail, torch),
                                       device_ms=_device_ms(tail, torch))}


def turn(root, kernels_only=False):
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
    if kernels_only:
        res["kernels"] = _kernel_times(cs, torch, dev)
        print("AB " + json.dumps(res), flush=True)
        return
    params = inspect.signature(cs.kernel_checks).parameters
    kres = cs.kernel_checks(tt, torch, dev, *([floor] if "floor" in params
                                              else []))
    res["phase2"] = {k: {name: {label: {f: r[f] for f in ("ms", "plain_ms",
                                                         "bound_ms")
                                        if f in r}
                                for label, r in cases.items()}
                         for name, cases in v.items()}
                     for k, v in kres.items()}
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
    e02 = [cs.sample_run(tt, torch, Js, 8, torch.float32, f"e02 fleet {label}",
                         cs.E02_M, seed=cs.FLEET_SEED)
           for label in ("f32 cold", "f32 warm 1", "f32 warm 2", "f32 warm 3")]
    res["e02_fleet_s"] = [r[0] for r in e02]
    res["e02_fleet_stages"] = [r[1] for r in e02]
    s2048 = [cs.sample_run(tt, torch, [J], 16, torch.float32,
                           f"chimera-2048 {label}", cs.E2048_M)
             for label in ("f32 cold", "f32 warm 1", "f32 warm 2",
                           "f32 warm 3")]
    res["sample2048_s"] = [r[0] for r in s2048]
    res["sample2048_stages"] = [r[1] for r in s2048]
    print("AB " + json.dumps(res), flush=True)


def main():
    args = sys.argv[1:]
    kernels_only = args[:1] == ["--kernels"]
    if kernels_only:
        args = args[1:]
    if len(args) == 2 and args[0] == "--turn":
        turn(args[1], kernels_only)
        return
    if not args:
        sys.exit(__doc__)
    t0 = time.perf_counter()
    for root in args:
        subprocess.run([sys.executable, os.path.abspath(__file__)]
                       + ["--kernels"] * kernels_only + ["--turn", root],
                       check=True)
        print(f"smoke_ab: turn {root} done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
