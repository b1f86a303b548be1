#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tnax_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It
  1. prints the card and its power limit and builds the three kernels;
  2. compares each kernel with its plain PyTorch version on the card at
     the flagship shapes, in float32 and float64, and times both (median
     of 20 launches, CUDA events);
  3. drives the flagship ground-state search through the public entry
     points (load_Jij -> Solver -> parallel.flagship_search_gs) on the
     committed synthetic chimera-2048 instance at M=1024, D=32, cutoff
     1e-8: float64 cold and warm, float32 cold and three warm runs, with
     per-stage times; the launch counters show that every kernel ran, the
     returned energy is checked against ``energy_Jij`` of the returned
     state, and the float64 energy against the committed tnax oracle.
The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line is printed. Without a CUDA card it fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
INSTANCE = os.path.join(ROOT, "tests", "data", "chimera2048_synth_s0.txt")
ORACLE = os.path.join(ROOT, "tests", "data",
                      "chimera2048_synth_s0_oracle.json")
REPS = 20
# comparison tolerances of kernel vs plain version, by dtype name
RTOL = {"float32": 1e-5, "float64": 1e-12}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(fn, torch):
    """Median milliseconds of ``fn`` over REPS runs (CUDA events), after
    one warm-up run."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a, b, torch):
    a, b = a.double(), b.double()
    both_neg = (a <= -1e29) & (b <= -1e29)
    d = torch.where(both_neg, 0.0, (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def kernel_checks(tt, torch, dev):
    """Phase 2: each kernel against its plain version on the card."""
    from tnax_torch import kernels
    from tnax_torch.parallel import select_groups
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        rtol = RTOL[name]

        def rand(*shape):
            return torch.randn(shape, generator=gen,
                               dtype=torch.float64).to(dev, dtype)

        # K1: 15 interface environments of 16 x 16, badly scaled
        A = rand(15, 16, 16) * torch.exp2(torch.randint(
            -20, 20, (15, 16, 1), generator=gen)).to(dev, dtype)
        nd = torch.full((15,), 16, dtype=torch.int32, device=dev)
        nd[3] = 9
        got = kernels.gebal_scale(A, nd, 32.0)
        want = kernels.gebal_scale_plain(A, nd, 32.0)
        check(torch.equal(got, want), f"K1 gebal {name}: scales differ")
        out.setdefault("gebal", {})[name] = dict(
            max_abs_err=max_abs_err(got, want, torch),
            ms=median_ms(lambda: kernels.gebal_scale(A, nd, 32.0), torch),
            plain_ms=median_ms(lambda: kernels.gebal_scale_plain(A, nd, 32.0),
                               torch))

        # K2: C = 8 * 1024 candidates with repeated keys and energy ties
        C, M = 8192, 1024
        key1 = (torch.randint(0, 3000, (C,), generator=gen) << 1).to(
            dev, torch.int32)
        valid = (torch.rand(C, generator=gen) < 0.9).to(dev)
        key1 = key1 | (~valid).to(torch.int32)
        Eng = (torch.randint(-300, 300, (C,), generator=gen) / 75.0).to(
            dev, torch.float64)
        prob = -rand(C).abs() * 20
        deg = torch.randint(1, 1000, (C,), generator=gen).to(dev)
        segs_k = kernels.merge_segments(key1, Eng, prob, valid, deg, 1e-12)
        segs_p = kernels.merge_segments_plain(key1, Eng, prob, valid, deg,
                                              1e-12)
        for i, part in enumerate(("perm", "seg", "Emin", "first_min")):
            check(torch.equal(segs_k[i], segs_p[i]),
                  f"K2 merge {name}: {part} differs")
        check(torch.equal(segs_k[5], segs_p[5]),
              f"K2 merge {name}: degeneracy sums differ")
        sel_k = select_groups(*segs_k, valid, M)
        sel_p = select_groups(*segs_p, valid, M)
        for i, part in ((0, "slot"), (1, "rep"), (6, "degeneracy")):
            check(torch.equal(sel_k[i], sel_p[i]),
                  f"K2 merge {name}: {part} differs")
        check(torch.allclose(segs_k[4], segs_p[4], rtol=rtol, atol=rtol)
              and torch.allclose(sel_k[2], sel_p[2], rtol=rtol, atol=rtol),
              f"K2 merge {name}: probabilities differ beyond rtol {rtol}")
        out.setdefault("merge", {})[name] = dict(
            max_abs_err=max_abs_err(segs_k[4], segs_p[4], torch),
            ms=median_ms(lambda: kernels.merge_segments(
                key1, Eng, prob, valid, deg, 1e-12), torch),
            plain_ms=median_ms(lambda: kernels.merge_segments_plain(
                key1, Eng, prob, valid, deg, 1e-12), torch))

        # K3: M = 1024 branches, Np = 256 states, lh = lv = 16
        Np, lh, lv = 256, 16, 16
        T2 = rand(M, lv * lh).abs() - 0.05 * rand(M, lv * lh).abs()
        lB = -rand(Np, lh, lv).abs() * 30
        lB[200:] = -float("inf")
        drindex = torch.randperm(lv * lh, generator=gen)[:Np].to(dev)
        lidx = torch.randint(0, lh, (M,), generator=gen).to(dev)
        uidx = torch.randint(0, lv, (M,), generator=gen).to(dev)
        probv = -rand(M).abs() * 50
        bvalid = (torch.rand(M, generator=gen) < 0.8).to(dev)
        args = (T2, lB, drindex, lidx, uidx, 200, probv, bvalid)
        pf_k, mq_k = kernels.marginal_epilogue(*args)
        pf_p, mq_p = kernels.marginal_epilogue_plain(*args)
        check(torch.equal(pf_k <= -1e29, pf_p <= -1e29),
              f"K3 marginal {name}: NEG pattern differs")
        check(torch.allclose(pf_k, pf_p, rtol=rtol, atol=rtol)
              and torch.allclose(mq_k, mq_p, rtol=rtol, atol=rtol),
              f"K3 marginal {name}: differs beyond rtol {rtol}")
        out.setdefault("marginal_epilogue", {})[name] = dict(
            max_abs_err=max(max_abs_err(pf_k, pf_p, torch),
                            max_abs_err(mq_k, mq_p, torch)),
            ms=median_ms(lambda: kernels.marginal_epilogue(*args), torch),
            plain_ms=median_ms(lambda: kernels.marginal_epilogue_plain(*args),
                               torch))
    for k, v in out.items():
        for name, r in v.items():
            print(f"kernel {k:18s} {name}: kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  max_abs_err "
                  f"{r['max_abs_err']:.3g}", flush=True)
    return out


def slice_run(tt, torch, J, oracle, dtype, label):
    """One flagship search; returns (seconds, stage times, result,
    recomputed energy, launch counts of this run)."""
    from tnax_torch import kernels
    ins = tt.Solver(mode="Ising", Nx=oracle["Nx"], Ny=oracle["Ny"],
                    Nc=oracle["Nc"], J=J, beta=oracle["beta"], device="cuda",
                    dtype=dtype)
    stages = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tt.parallel.flagship_search_gs(
        ins, M=oracle["M"], relative_P_cutoff=oracle["relative_P_cutoff"],
        Dmax=oracle["Dmax"], stage_times=stages)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ins.states = res["states"][None, :][:, ins.order]
    E = float(tt.energy_Jij(J, ins.binary_states())[0])
    print(f"slice {label}: {seconds:.3f} s  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f"  energy {res['energy']:.6f} recheck {E:.6f} oracle "
          f"{oracle['energy']:.6f}  deg {res['degeneracy']}  merge_overflow "
          f"{res['merge_overflow']}  count_max {res['count_max']}  "
          f"launches {counts}", flush=True)
    for k, n in counts.items():
        check(n > 0, f"slice {label}: kernel {k} was not launched")
    return seconds, stages, res, E, counts


def main():
    if not os.path.isdir(os.path.join(ROOT, "tnax_torch")):
        fail("no tnax_torch package beside chip_smoke.py")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    sys.path.insert(0, ROOT)
    import tnax_torch as tt
    from tnax_torch.kernels import build

    # phase 1: the card, and the kernels' build
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    for name in ("gebal", "merge"):
        build.load(name)
        print(f"built {name}: {build.build_logs.get(name, '').strip()}",
              flush=True)
    print(f"nvcc builds: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    kres = kernel_checks(tt, torch, dev)

    # phase 3: the slice through its entry points
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)
    with open(ORACLE) as f:
        oracle = json.load(f)
    runs = {}
    for dtype, labels in ((torch.float64, ["f64 cold", "f64 warm"]),
                          (torch.float32, ["f32 cold", "f32 warm 1",
                                           "f32 warm 2", "f32 warm 3"])):
        for label in labels:
            runs[label] = slice_run(tt, torch, J, oracle, dtype, label)
            _, _, res, E, _ = runs[label]
            tol = 1e-9 if dtype == torch.float64 else 1e-3
            check(abs(res["energy"] - E) <= tol,
                  f"{label}: returned energy {res['energy']} != recheck {E}")
            if dtype == torch.float64:
                check(E <= oracle["energy"] + 1e-6,
                      f"{label}: energy {E} above the oracle "
                      f"{oracle['energy']}")
    warm = [runs[f"f32 warm {i}"][0] for i in (1, 2, 3)]
    print(f"f32 warm median {statistics.median(warm):.3f} s, spread "
          f"{max(warm) - min(warm):.3f} s; f32 energy "
          f"{runs['f32 warm 1'][3]:.6f} vs oracle {oracle['energy']:.6f}",
          flush=True)

    # summary: kernel numbers in float32, launches of the last f32 run
    last = runs["f32 warm 3"][4]
    src = {"gebal": ("cuda", "tnax_torch/kernels/csrc/gebal.cu",
                     "tnax/precondition.py:280"),
           "merge": ("cuda", "tnax_torch/kernels/csrc/merge.cu",
                     "tnax/parallel.py:149"),
           "marginal_epilogue": ("triton",
                                 "tnax_torch/kernels/marginal_triton.py",
                                 "tnax/engine.py:382")}
    summary = []
    for name, (route, source, replaces) in src.items():
        r = kres[name]["float32"]
        summary.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=last[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
