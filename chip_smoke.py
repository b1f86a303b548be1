#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tnax_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It
  1. prints the card and its power limit and builds the three kernels;
  2. compares each kernel with its plain PyTorch version on the card, in
     float32 and float64, at the single search's shapes (B = 1) and the
     fleet's (B = 8 instances in one launch), and times both (median of
     20 launches, CUDA events) beside the least time the card could take
     (``bound_ms``) and the time of one launch of a one-element kernel;
  3. drives the flagship ground-state search through the public entry
     points (load_Jij -> Solver -> parallel.flagship_search_gs) on the
     committed synthetic chimera-2048 instance at M=1024, D=32, cutoff
     1e-8: float64 cold and warm, float32 cold and three warm runs, with
     per-stage times; the launch counters show that every kernel ran, the
     returned energy is checked against ``energy_Jij`` of the returned
     state, and the float64 energy against the committed tnax oracle;
  4. drives the fleet (Solver -> parallel.multi_flagship_search_gs) on the
     8 committed chimera-512 instances at M=1024, D=32, cutoff 1e-8,
     cand_factor=2, beta=3: float64 once, float32 cold and three warm,
     with instances per minute; every returned energy is checked against
     its recheck, in float64 every instance against its tnax oracle
     (energy and degeneracy), and each kernel's launches per batch against
     one launch per site (K2, K3) or per interface sweep step (K1) for the
     whole fleet; then the float32 single-instance runs of the same
     instances, whose agreement with the fleet is printed, not gated.
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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
INSTANCE = os.path.join(DATA, "chimera2048_synth_s0.txt")
ORACLE = os.path.join(DATA, "chimera2048_synth_s0_oracle.json")
FLEET = [os.path.join(DATA, f"chimera512_synth_s{s}") for s in range(1, 9)]
REPS = 20
# comparison tolerances of kernel vs plain version, by dtype name
RTOL = {"float32": 1e-5, "float64": 1e-12}
# peak rates of one H100 SXM (NVIDIA's data sheet; FP64 outside the tensor
# cores from the same sheet): device memory bytes/s, and operations/s by type
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 67e12, "float64": 34e12}


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(moved, ops, name):
    """(bound_ms, bound_by): the larger of the bytes moved over the
    memory rate and the operations over the peak rate of the dtype."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare_and_time(out, key, name, got, want, kernel, plain, moved, ops,
                     torch, extra_err=()):
    """Record one kernel case: max abs error, kernel and plain ms, bound."""
    bms, by = bound(moved, ops, name)
    out.setdefault(key[0], {}).setdefault(name, {})[key[1]] = dict(
        max_abs_err=max([max_abs_err(got, want, torch)]
                        + [max_abs_err(a, b, torch) for a, b in extra_err]),
        ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
        bound_ms=bms, bound_by=by)


def kernel_checks(tt, torch, dev):
    """Phase 2: each kernel against its plain version on the card, at the
    single search's shapes (B = 1) and the fleet's (B = 8)."""
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

        # K1: the interface environments of one ladder step, 16 x 16,
        # badly scaled: 15 (chimera-2048) and 8 x 7 (the fleet)
        for nmat, label in ((15, "B1"), (56, "B8")):
            A = rand(nmat, 16, 16) * torch.exp2(torch.randint(
                -20, 20, (nmat, 16, 1), generator=gen)).to(dev, dtype)
            nd = torch.full((nmat,), 16, dtype=torch.int32, device=dev)
            nd[3] = 9
            got = kernels.gebal_scale(A, nd, 32.0)
            want = kernels.gebal_scale_plain(A, nd, 32.0)
            check(torch.equal(got, want),
                  f"K1 gebal {name} {label}: scales differ")
            # one scaling pass over every column: the least any input needs
            compare_and_time(
                out, ("gebal", label), name, got, want,
                lambda: kernels.gebal_scale(A, nd, 32.0),
                lambda: kernels.gebal_scale_plain(A, nd, 32.0),
                nbytes(A, nd, got), 6 * 16 * 16 * nmat, torch)

        # K2: C = 8 * 1024 candidates of one instance, and the fleet's
        # 8 instances of C = 2 * 1024, with repeated keys and energy ties
        M = 1024
        for B, C, label in ((1, 8192, "B1"), (8, 2048, "B8")):
            key1 = (torch.randint(0, 3000 * C // 8192, (B, C), generator=gen)
                    << 1).to(dev, torch.int32)
            valid = (torch.rand((B, C), generator=gen) < 0.9).to(dev)
            key1 = key1 | (~valid).to(torch.int32)
            Eng = (torch.randint(-300, 300, (B, C), generator=gen)
                   / 75.0).to(dev, torch.float64)
            prob = -rand(B, C).abs() * 20
            deg = torch.randint(1, 1000, (B, C), generator=gen).to(dev)
            segs_k = kernels.merge_segments(key1, Eng, prob, valid, deg,
                                            1e-12)
            for b in range(B):
                segs_p = kernels.merge_segments_plain(
                    key1[b], Eng[b], prob[b], valid[b], deg[b], 1e-12)
                for i, part in ((0, "perm"), (1, "seg"), (2, "Emin"),
                                (3, "first_min"), (5, "degeneracy sums")):
                    check(torch.equal(segs_k[i][b], segs_p[i]),
                          f"K2 merge {name} {label}: {part} differs in "
                          f"instance {b}")
            segs_p = kernels.merge_segments_plain(key1, Eng, prob, valid,
                                                  deg, 1e-12)
            sel_k = select_groups(*segs_k, valid, M)
            sel_p = select_groups(*segs_p, valid, M)
            for i, part in ((0, "slot"), (1, "rep"), (6, "degeneracy")):
                check(torch.equal(sel_k[i], sel_p[i]),
                      f"K2 merge {name} {label}: {part} differs")
            check(torch.allclose(segs_k[4], segs_p[4], rtol=rtol, atol=rtol)
                  and torch.allclose(sel_k[2], sel_p[2], rtol=rtol,
                                     atol=rtol),
                  f"K2 merge {name} {label}: probabilities differ beyond "
                  f"rtol {rtol}")
            # a comparison sort needs C log2 C comparisons per instance
            compare_and_time(
                out, ("merge", label), name, segs_k[4], segs_p[4],
                lambda: kernels.merge_segments(key1, Eng, prob, valid, deg,
                                               1e-12),
                lambda: kernels.merge_segments_plain(key1, Eng, prob, valid,
                                                     deg, 1e-12),
                nbytes(key1, Eng, prob, valid, deg, *segs_k),
                B * C * max(1, (C - 1).bit_length()), torch)

        # K3: M = 1024 branches, Np = 256 states, lh = lv = 16, of one
        # instance and of the fleet's 8, whose counts of valid states
        # differ
        Np, lh, lv = 256, 16, 16
        for nvs, label in (([200], "B1"),
                           ([200, 256, 97, 1, 256, 180, 64, 255], "B8")):
            B = len(nvs)
            T2 = rand(B, M, lv * lh).abs() - 0.05 * rand(B, M, lv * lh).abs()
            lB = -rand(B, Np, lh, lv).abs() * 30
            for b, nv in enumerate(nvs):
                lB[b, nv:] = -float("inf")
            drindex = torch.stack([torch.randperm(lv * lh, generator=gen)[:Np]
                                   for _ in range(B)]).to(dev)
            lidx = torch.randint(0, lh, (B, M), generator=gen).to(dev)
            uidx = torch.randint(0, lv, (B, M), generator=gen).to(dev)
            nvalid = torch.tensor(nvs, device=dev)
            probv = -rand(B, M).abs() * 50
            bvalid = (torch.rand((B, M), generator=gen) < 0.8).to(dev)
            args = (T2, lB, drindex, lidx, uidx, nvalid, probv, bvalid)
            pf_k, mq_k = kernels.marginal_epilogue(*args)
            pf_p, mq_p = kernels.marginal_epilogue_plain(*args)
            check(torch.equal(pf_k <= -1e29, pf_p <= -1e29),
                  f"K3 marginal {name} {label}: NEG pattern differs")
            check(torch.allclose(pf_k, pf_p, rtol=rtol, atol=rtol)
                  and torch.allclose(mq_k, mq_p, rtol=rtol, atol=rtol),
                  f"K3 marginal {name} {label}: differs beyond rtol {rtol}")
            # about ten operations per (branch, state): gather, shift, exp,
            # mask, min, clamp, sum, divide, log2, add
            compare_and_time(
                out, ("marginal_epilogue", label), name, pf_k, pf_p,
                lambda: kernels.marginal_epilogue(*args),
                lambda: kernels.marginal_epilogue_plain(*args),
                nbytes(*args, pf_k, mq_k), 10 * B * M * Np, torch,
                extra_err=[(mq_k, mq_p)])
    for k, v in out.items():
        for name, cases in v.items():
            for label, r in cases.items():
                print(f"kernel {k:18s} {name} {label}: kernel {r['ms']:.4f} "
                      f"ms  plain {r['plain_ms']:.4f} ms  bound "
                      f"{r['bound_ms']:.6f} ms ({r['bound_by']})  "
                      f"max_abs_err {r['max_abs_err']:.3g}", flush=True)
    return out


def launch_floor_ms(torch, dev):
    """Median time of one launch of a one-element kernel: the floor that
    every kernel launch pays, whatever its work."""
    x = torch.zeros(1, device=dev)
    return median_ms(lambda: x.add_(1.0), torch)


def recheck(tt, J, ins, states):
    ins.states = states[None, :][:, ins.order]
    return float(tt.energy_Jij(J, ins.binary_states())[0])


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
    E = recheck(tt, J, ins, res["states"])
    print(f"slice {label}: {seconds:.3f} s  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f"  energy {res['energy']:.6f} recheck {E:.6f} oracle "
          f"{oracle['energy']:.6f}  deg {res['degeneracy']}  merge_overflow "
          f"{res['merge_overflow']}  count_max {res['count_max']}  "
          f"launches {counts}", flush=True)
    for k, n in counts.items():
        check(n > 0, f"slice {label}: kernel {k} was not launched")
    return seconds, stages, res, E, counts


def fleet_run(tt, torch, Js, oracles, dtype, label):
    """One fleet search over the 8 chimera-512 instances; returns
    (seconds, stage times, results, recomputed energies, launch counts of
    this run)."""
    from tnax_torch import kernels
    o = oracles[0]
    solvers = [tt.Solver(mode="Ising", Nx=o["Nx"], Ny=o["Ny"], Nc=o["Nc"],
                         J=J, beta=o["beta"], device="cuda", dtype=dtype)
               for J in Js]
    stages = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rs = tt.parallel.multi_flagship_search_gs(
        solvers, M=o["M"], relative_P_cutoff=o["relative_P_cutoff"],
        Dmax=o["Dmax"], cand_factor=o["cand_factor"], stage_times=stages)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    Es = [recheck(tt, J, ins, r["states"])
          for J, ins, r in zip(Js, solvers, rs)]
    print(f"fleet {label}: {seconds:.3f} s  {60 * len(Js) / seconds:.2f} "
          f"instances/min  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f"  launches {counts}", flush=True)
    for b, (r, E, orc) in enumerate(zip(rs, Es, oracles)):
        print(f"  {orc['instance']}: energy {r['energy']:.6f} recheck "
              f"{E:.6f} oracle {orc['energy']:.6f}  deg {r['degeneracy']} "
              f"(oracle {orc['degeneracy']})  merge_overflow "
              f"{r['merge_overflow']}  count_max {r['count_max']}",
              flush=True)
    return seconds, stages, rs, Es, counts


def fleet_phase(tt, torch):
    """Phase 4: the fleet through its entry points; returns the launch
    counts of the last float32 batch."""
    Js, oracles = [], []
    for base in FLEET:
        Js.append(tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")),
                               1 / 75))
        with open(base + "_oracle.json") as f:
            oracles.append(json.load(f))
    o = oracles[0]
    want = dict(gebal=2 * o["Nx"], merge=o["Nx"] * o["Ny"],
                marginal_epilogue=o["Nx"] * o["Ny"])   # pre_steps = 1
    runs = {}
    for dtype, labels in ((torch.float64, ["f64"]),
                          (torch.float32, ["f32 cold", "f32 warm 1",
                                           "f32 warm 2", "f32 warm 3"])):
        for label in labels:
            runs[label] = fleet_run(tt, torch, Js, oracles, dtype, label)
            _, _, rs, Es, counts = runs[label]
            check(counts == want, f"fleet {label}: launches {counts}, "
                  f"want {want} (one per site or sweep step per batch)")
            tol = 1e-9 if dtype == torch.float64 else 1e-3
            for r, E, orc in zip(rs, Es, oracles):
                check(abs(r["energy"] - E) <= tol,
                      f"fleet {label} {orc['instance']}: returned energy "
                      f"{r['energy']} != recheck {E}")
                if dtype == torch.float64:
                    check(E <= orc["energy"] + 1e-6
                          and r["degeneracy"] == orc["degeneracy"],
                          f"fleet {label} {orc['instance']}: energy {E} deg "
                          f"{r['degeneracy']}, oracle {orc['energy']} deg "
                          f"{orc['degeneracy']}")
    warm = [runs[f"f32 warm {i}"][0] for i in (1, 2, 3)]
    print(f"fleet f32 warm median {statistics.median(warm):.3f} s, spread "
          f"{max(warm) - min(warm):.3f} s, "
          f"{60 * len(Js) / statistics.median(warm):.2f} instances/min",
          flush=True)
    # the f32 fleet against the f32 single-instance runs (printed only:
    # batched cuSOLVER calls may round otherwise than single ones)
    fleet_E = [r["energy"] for r in runs["f32 warm 3"][2]]
    same, t0 = 0, time.perf_counter()
    for J, E_fleet, orc in zip(Js, fleet_E, oracles):
        ins = tt.Solver(mode="Ising", Nx=o["Nx"], Ny=o["Ny"], Nc=o["Nc"],
                        J=J, beta=o["beta"], device="cuda",
                        dtype=torch.float32)
        r = tt.parallel.flagship_search_gs(
            ins, M=o["M"], relative_P_cutoff=o["relative_P_cutoff"],
            Dmax=o["Dmax"], cand_factor=o["cand_factor"])
        same += abs(r["energy"] - E_fleet) <= 1e-9
        print(f"  single f32 {orc['instance']}: energy {r['energy']:.6f} "
              f"fleet {E_fleet:.6f}", flush=True)
    print(f"f32 fleet vs single runs: {same} of {len(Js)} energies agree; "
          f"8 single runs {time.perf_counter() - t0:.3f} s", flush=True)
    return runs["f32 warm 3"][4]


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
    names = ("gebal", "merge")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(build.load, names))
    for name in names:
        print(f"built {name}: {build.build_logs.get(name, '').strip()}",
              flush=True)
    print(f"nvcc builds: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    kres = kernel_checks(tt, torch, dev)
    floor = launch_floor_ms(torch, dev)
    print(f"launch floor (one-element kernel): {floor:.4f} ms", flush=True)

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

    single = runs["f32 warm 3"][4]

    # phase 4: the fleet through its entry points
    fleet = fleet_phase(tt, torch)

    # summary: kernel numbers in float32 at the fleet's shapes, launches
    # of the last f32 fleet batch (and of the last f32 single search)
    src = {"gebal": ("cuda", "tnax_torch/kernels/csrc/gebal.cu",
                     "tnax/precondition.py:280"),
           "merge": ("cuda", "tnax_torch/kernels/csrc/merge.cu",
                     "tnax/parallel.py:149"),
           "marginal_epilogue": ("triton",
                                 "tnax_torch/kernels/marginal_triton.py",
                                 "tnax/engine.py:382")}
    summary = []
    for name, (route, source, replaces) in src.items():
        r = kres[name]["float32"]["B8"]
        summary.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=fleet[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None,
                            launch_floor_ms=floor,
                            launches_single=single[name]))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
