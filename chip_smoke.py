#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tnax_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. It
  1. prints the card and its power limit and builds the six kernels, one
     nvcc per source, all at once;
  2. compares each kernel with its plain PyTorch version on the card, in
     float32 and float64, at the single search's shapes (B = 1) and the
     fleet's (B = 8 instances in one launch), K1 also on badly balanced
     matrices (entries spanning 2^-50 .. 2^50, a zero row and column, nd <
     n), K2 also at the tiled sizes up to the full expansion (1 x 65,536,
     1 x 262,144, 8 x 65,536), K4 (the sampler's site step) at the
     sampling points' shapes (D = 48: 128 walkers of one instance and of
     8, 1024 walkers, a ragged fleet), and
     prints per kernel and shape the time of one wrapper call and of the
     plain version (median of 20 calls, CUDA events), the device time
     alone (20 calls captured in one CUDA graph, per call), the least time
     the card could take (``bound_ms``) and the launch floor (one launch
     of a one-element kernel); for K2 also ``torch.sort(stable=True)`` of
     the keys, the time of the sort alone; K5 (the ladder's variational
     polish) in float32 on every row of the chimera-2048 ladder (2 lanes)
     and of the chimera-512 fleet's (16 lanes) against the plain polish,
     with the whole ladder's polish time of both (``polish_checks``); K6
     (the ladder's zip-up and truncation sweep) likewise against the plain
     steps on the same rows, with a row's wrapper, device and plain times
     and the bound (``zipup_checks``);
  3. drives the flagship ground-state search through the public entry
     points (load_Jij -> Solver -> parallel.flagship_search_gs) on the
     committed synthetic chimera-2048 instance at M=1024, D=32, cutoff
     1e-8: at the default merge cap (cand_factor=8) float64 once,
     float32 cold and three warm runs, then the full expansion
     (cand_factor=None, C = M * Np = 262,144 candidates per site) float64
     once and float32 cold and warm, with per-stage times; the
     launch counters show that every kernel ran (at the full expansion K2
     and K3 once per site), the returned energy is checked against
     ``energy_Jij`` of the returned state, the float64 energy against the
     committed tnax oracle of its cap, and the full expansion for no
     merge overflow;
  4. drives the fleet (Solver -> parallel.multi_flagship_search_gs) on the
     8 committed chimera-512 instances at M=1024, D=32, cutoff 1e-8,
     cand_factor=2, beta=3: float64 once, float32 cold and three warm,
     with instances per minute; every returned energy is checked against
     its recheck, in float64 every instance against its tnax oracle
     (energy and degeneracy), and each kernel's launches per batch against
     one launch per site (K2, K3) or per interface sweep step (K1) for the
     whole fleet; then the float32 single-instance runs of the same
     instances, whose agreement with the fleet is printed, not gated;
  5. drives Gibbs sampling through its entry points (Solver ->
     flagship_sample / multi_flagship_sample) at beta=3, D=48,
     pre_steps=2: the e02 point (128 walkers) on chimera512_synth_s1
     (float64 once, float32 cold and three warm) and on the fleet of 8
     (float64 once, float32 cold and warm), and 1024 walkers on
     chimera-2048 (float32 and float64 with every draw examined), with
     stage times, samples per second and instances per minute; every sampled energy is checked
     against ``energy_Jij`` of its state, the launches of K4 against one
     per site and of K1 against one per interface sweep step, and the
     float64 mean energy on s1 against the committed tnax sampling
     oracle (K4 runs the whole site step after the two GEMMs, so its
     launches are the site loop's); the float32 fleet's first two
     instances are printed beside single runs on the same uniforms, and
     the examined passes print their
     draws from the uniform row (saturated or vanishing marginals) by
     cause: the float64 pass must have none;
  6. drives the low-energy spectrum through the Solver's entry points
     (add_noise -> precondition -> search_low_energy_spectrum with
     auto_grow -> decode_low_energy_states; multi_search_spectrum for the
     fleet): chimera-128 in float64 with the exact-SVD zip-up, ee=1 and
     ee=2 after noise, gated on the committed tnax oracle (same number of
     states, same sorted energies within 1e-9; whether the sets of states
     are equal is printed), and a float32 ee=1 gated on its lowest energy;
     chimera-2048 at bench.py's spectrum point (noise, the two-rung ladder,
     ee=2, M=1024, D=32, cand_factor=64) in float32 and in float64,
     gated on no merge overflow and a lowest energy within the
     noise bound of the GS oracle, float64 also on two states within
     twice the bound; the 8 chimera-512 instances through
     multi_search_spectrum (float32, ee=1, cand_factor=8) once,
     each instance's lowest energy gated on its GS oracle. Every decoded
     energy is checked against ``energy_Jij`` of its state (1e-9), K2 and
     K3 against one launch per site and pass; stage times (ladder,
     boundary, records on the device, replay and decode on the host) and
     the final cap are printed;
  7. drives the Solver's own paths through its methods (precondition,
     both search, sampling and spectrum paths, RMF, save/load; see
     ``solver_phase``);
  8. drives the host preconditioner and the MPS API (``host_pre_phase``):
     precondition(path="host") at chimera-2048 then the device search,
     gated on the oracle; 'ud' + 'lr' there, the gauge invariants exactly
     and both searches against their rechecks; at chimera-512 s1 in
     float64 the host 'ud' against the device ladder (K1) at tnax's
     tolerances and 'ud' + 'lr' + the host search against the oracle;
     the boundary stacks (rhoT/B/L/R, the fat rhoT) and the MPS API on
     the card against the CPU;
  9. drives the device mesh on torch.distributed (``mesh_phase``): a
     (1, 1) NCCL mesh in this process, sharded_search_gs at chimera-2048
     on phase 7's gauges against the oracle and multi_search_gs; then two
     spawned gloo ranks on the one card: the beam-sharded search on
     chimera-512 s1 against its oracle, the data-parallel fleet search
     and sampler against no mesh, and the beam-sharded spectrum against
     the chimera-128 spectrum oracle.
The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line is printed. Without a CUDA card it fails.
"""

import json
import math
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
FULL_ORACLE = os.path.join(DATA, "chimera2048_synth_s0_full_oracle.json")
FLEET = [os.path.join(DATA, f"chimera512_synth_s{s}") for s in range(1, 9)]
SAMPLE_ORACLE = os.path.join(DATA, "chimera512_synth_s1_sample_oracle.json")
SPECTRUM_ORACLE = os.path.join(DATA,
                               "chimera128_synth_s0_spectrum_oracle.json")
# the sampling points: beta=3, D=48, a two-rung ladder; the e02 point
# draws 128 walkers per instance, chimera-2048 1024
SAMPLE_KW = dict(Dmax=48, pre_steps=2)
E02_M, E2048_M = 128, 1024
FLEET_SEED = 1   # the single e02 run is stream 0 of seed 0
REPS = 20
SEARCH_KERNELS = ("gebal", "merge", "marginal_epilogue")
# K2's checks: (B, C, label) and chimera-2048's key bits,
# bitlen(M - 1) + 2 * bits + 1 = 10 + 8 + 1
MERGE_SHAPES = ((1, 8192, "B1"), (8, 2048, "B8"), (1, 65536, "B1_65536"),
                (1, 262144, "B1_full"), (8, 65536, "B8_65536"))
KB = 19
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


def gathered_bytes(T2, lBT, drindex, lidx, uidx, nvalid, torch):
    """Bytes K3 must read of its gathered inputs: the Np-state Boltzmann
    column lBT[b, l, u, :] once for each distinct (l, u) pair of instance
    b, the valid states' entries of each branch's row of T2, and the
    64-bit indices."""
    lv, Np = lBT.shape[2], lBT.shape[3]
    pairs = sum(int(torch.unique(lidx[b].long() * lv + uidx[b].long()).numel())
                for b in range(lidx.shape[0]))
    nv = int(nvalid.long().clamp(max=Np).sum())
    return (pairs * Np + nv * lidx.shape[1]) * T2.element_size() \
        + 8 * (nv + 2 * lidx.numel() + nvalid.numel())


# sample_site's arguments, in order
SITE_KEYS = ("T2", "lBT", "drindex", "dmap", "rmap", "nvalid", "u", "AT",
             "RL", "vind", "states", "nx", "col", "mq")


def site_case(gen, nvs, M, dtype, dev, torch, D=48):
    """K4's inputs for one instance per entry of ``nvs`` (its valid
    states) and M walkers, at chimera's widths (Np = 256, lh = lv = 16)
    and the sampling points' D, as the sampler holds them: the table with
    the states last, int64 drindex and nvalid, int32 dmap, rmap, vind
    (Nx + 1 = 17 columns, the site at nx = 5) and states (256 columns),
    mq = +inf."""
    from tnax_torch.kernels.marginal import boltzmann_columns
    Np, lh, lv, B = 256, 16, 16, len(nvs)

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           dtype=torch.float64).to(dev, dtype)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    T2 = rand(B, M, lv * lh).abs() - 0.05 * rand(B, M, lv * lh).abs()
    lB = -rand(B, Np, lh, lv).abs() * 30
    for b, nv in enumerate(nvs):
        lB[b, nv:] = -float("inf")
    return dict(
        T2=T2, lBT=boltzmann_columns(lB),
        drindex=torch.stack([torch.randperm(lv * lh, generator=gen)[:Np]
                             for _ in range(B)]).to(dev),
        dmap=ints(lv, (B, Np)), rmap=ints(lh, (B, Np)),
        nvalid=torch.tensor(nvs, device=dev),
        u=torch.rand((B, M), generator=gen,
                     dtype=torch.float64).to(dev, dtype),
        AT=rand(B, D, lv, D), RL=rand(B, M, D), vind=ints(16, (B, M, 17)),
        states=torch.zeros((B, M, 256), dtype=torch.int32, device=dev),
        nx=5, col=37,
        mq=torch.full((B,), float("inf"), dtype=dtype, device=dev))


def walkers_copy(a):
    """K4's inputs ``a`` with copies of what it updates in place."""
    return dict(a, vind=a["vind"].clone(), states=a["states"].clone(),
                mq=a["mq"].clone())


def site_bytes(a, after, RLn, mPn, torch):
    """Bytes K4 must move on the inputs ``a``, with ``after`` the walkers
    it left: each walker's column once per distinct (l, u) pair of its
    instance, T2's and drindex's valid entries, the drawn entries of dmap
    and rmap, AT's D x D slice of each distinct drawn down-leg, RL in and
    out, u, nvalid, the vind reads and writes, the states, mPn and mq
    writes."""
    T2, lBT, nx, col = a["T2"], a["lBT"], a["nx"], a["col"]
    B, M = T2.shape[:2]
    lv, Np, D = lBT.shape[2], lBT.shape[3], a["RL"].shape[2]
    e = T2.element_size()

    def distinct(x):
        return sum(int(torch.unique(x[b]).numel()) for b in range(B))
    pairs = distinct(a["vind"][:, :, nx].long() * lv
                     + a["vind"][:, :, nx + 1].long())
    nv = int(a["nvalid"].clamp(max=Np).sum())
    return (pairs * Np + nv * M + distinct(after["vind"][:, :, nx]) * D * D) \
        * e + 8 * nv + 8 * distinct(after["states"][:, :, col]) \
        + nbytes(a["RL"], RLn, a["u"], mPn, a["mq"], a["nvalid"]) \
        + 4 * B * M * 5


def bound(moved, ops, name):
    """(bound_ms, bound_by): the larger of the bytes moved over the
    memory rate and the operations over the peak rate of the dtype."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(fn, torch):
    """Device time of one call of ``fn`` alone: REPS calls captured in one
    CUDA graph and replayed back to back, per call (median of 5 replays).
    The host's work in the wrapper is not in it."""
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
    del g
    return statistics.median(times)


def compare_and_time(out, key, name, got, want, kernel, plain, moved, ops,
                     torch, extra_err=(), extra=None):
    """Record one kernel case: max abs error, wrapper, device-only and
    plain ms, bound."""
    bms, by = bound(moved, ops, name)
    out.setdefault(key[0], {}).setdefault(name, {})[key[1]] = dict(
        max_abs_err=max([max_abs_err(got, want, torch)]
                        + [max_abs_err(a, b, torch) for a, b in extra_err]),
        ms=median_ms(kernel, torch), device_ms=device_ms(kernel, torch),
        plain_ms=median_ms(plain, torch), bound_ms=bms, bound_by=by,
        **(extra or {}))


def merge_case(gen, B, C, dtype, dev, torch):
    """K2's inputs: B rows of C candidates with keys in [0, 2**KB), about
    C / 4 groups of random size per row and the largest key in every row;
    energies in multiples of 1/75 (ties), 10% invalid, int64 degeneracies
    up to 2**40."""
    groups = torch.randint(0, 2 ** KB - 1, (B, max(1, C // 4)),
                           generator=gen)
    key1 = groups.gather(1, torch.randint(0, groups.shape[1], (B, C),
                                          generator=gen))
    key1[:, torch.randint(0, C, (max(1, C // 64),), generator=gen)] = \
        2 ** KB - 1
    return (key1.to(dev, torch.int32),
            (torch.randint(-300, 300, (B, C), generator=gen) / 75.0).to(
                dev, torch.float64),
            (-torch.randn((B, C), generator=gen, dtype=torch.float64).abs()
             * 20).to(dev, dtype),
            (torch.rand((B, C), generator=gen) < 0.9).to(dev),
            torch.randint(1, 2 ** 40, (B, C), generator=gen).to(dev))


def kernel_checks(tt, torch, dev, floor):
    """Phase 2: each kernel against its plain version on the card, at the
    single search's shapes (B = 1) and the fleet's (B = 8), K2 also up to
    the full expansion; ``floor`` is the launch floor in ms."""
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
        # badly scaled: 15 (chimera-2048) and 8 x 7 (the fleet); and 15
        # badly balanced ones (a similarity scaling 2^(k_i - k_j), k in
        # [-25, 25], so entries span 2^-50 .. 2^50; row 2 and column 5
        # zero; nd < n in every fifth)
        for nmat, label in ((15, "B1"), (56, "B8"), (15, "extreme")):
            if label == "extreme":
                k = torch.randint(-25, 26, (nmat, 16), generator=gen)
                A = rand(nmat, 16, 16) * torch.exp2(
                    k[:, :, None] - k[:, None, :]).to(dev, dtype)
                A[:, 2, :] = 0.0
                A[:, :, 5] = 0.0
                nd = torch.full((nmat,), 16, dtype=torch.int32, device=dev)
                nd[::5] = 13
            else:
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

        # K2: the main path's C = 8 * 1024 candidates of one instance, the
        # fleet's 8 instances of C = 2 * 1024, and the tiled sizes up to
        # the full expansion M * Np = 1024 * 256, with chimera-2048's
        # kb = 19 key bits (the largest key 2**19 - 1 in every row), about
        # C / 4 groups of random size, energy ties and 10% invalid
        M = 1024
        for B, C, label in MERGE_SHAPES:
            args = merge_case(gen, B, C, dtype, dev, torch)
            key1, valid = args[0], args[3]
            segs_k = kernels.merge_segments(*args, 1e-12, key_bits=KB)
            segs_p = kernels.merge_segments_plain(*args, 1e-12)
            for i, part in ((0, "perm"), (1, "seg"), (2, "Emin"),
                            (3, "first_min"), (5, "degeneracy sums")):
                check(torch.equal(segs_k[i], segs_p[i]),
                      f"K2 merge {name} {label}: {part} differs")
            sel_k = select_groups(*segs_k, valid, M)
            sel_p = select_groups(*segs_p, valid, M)
            for i, part in ((0, "slot"), (1, "rep"), (6, "degeneracy")):
                check(torch.equal(sel_k[i], sel_p[i]),
                      f"K2 merge {name} {label}: {part} differs")
            # the kernel adds a group's n near members in another order
            # than the plain version: two n-term sums of one sign differ by
            # at most 2 n eps relative, n the largest group
            n = int(max(torch.bincount(row).max() for row in segs_p[1]))
            tol = 2 * n * torch.finfo(dtype).eps
            check(torch.allclose(segs_k[4], segs_p[4], rtol=tol, atol=tol)
                  and torch.allclose(sel_k[2], sel_p[2], rtol=tol, atol=tol),
                  f"K2 merge {name} {label}: probabilities differ beyond "
                  f"rtol {tol:.3g} (largest group {n})")
            again = kernels.merge_segments(*args, 1e-12, key_bits=KB)[4]
            check(torch.equal(again, segs_k[4]),
                  f"K2 merge {name} {label}: gprob differs between runs")
            # a comparison sort needs C log2 C comparisons per instance
            compare_and_time(
                out, ("merge", label), name, segs_k[4], segs_p[4],
                lambda: kernels.merge_segments(*args, 1e-12, key_bits=KB),
                lambda: kernels.merge_segments_plain(*args, 1e-12),
                nbytes(*args, *segs_k), B * C * max(1, (C - 1).bit_length()),
                torch, extra=dict(
                    sort_ms=median_ms(lambda: torch.sort(key1, dim=1,
                                                         stable=True),
                                      torch), gprob_rtol=tol))

        # K3: M = 1024 branches, Np = 256 states, lh = lv = 16, of one
        # instance and of the fleet's 8, whose counts of valid states
        # differ; the table with the states last and int64 indices, as the
        # search holds them, and the search's cutoff window
        Np, lh, lv = 256, 16, 16
        log2_cutoff = float(math.log2(1e-8))
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
            args = (T2, kernels.marginal.boltzmann_columns(lB), drindex,
                    lidx, uidx, nvalid, probv, bvalid, log2_cutoff)
            out_k = kernels.marginal_epilogue(*args)
            out_p = kernels.marginal_epilogue_plain(*args)
            pf_k, mq_k, pmax, mq, mqc = out_k
            check(torch.equal(pf_k <= -1e29, out_p[0] <= -1e29),
                  f"K3 marginal {name} {label}: NEG pattern differs")
            for part, a, b in zip(("probf", "mPn", "pmax", "mq", "mqc"),
                                  out_k, out_p):
                check(torch.allclose(a, b, rtol=rtol, atol=rtol),
                      f"K3 marginal {name} {label}: {part} differs beyond "
                      f"rtol {rtol}")
            # the reductions of its own outputs, bit for bit
            bmax = torch.where(bvalid, probv, -1e30).amax(dim=1,
                                                          keepdim=True)
            core = bvalid & (probv > bmax + log2_cutoff)
            for part, got, want in (
                    ("pmax", pmax, pf_k.reshape(B, -1).amax(dim=1)),
                    ("mq", mq, torch.where(bvalid, mq_k, 0.0).amin(dim=1)),
                    ("mqc", mqc, torch.where(core, mq_k, 0.0).amin(dim=1))):
                check(torch.equal(got, want),
                      f"K3 marginal {name} {label}: {part} is not the "
                      f"reduction of the kernel's own outputs")
            # about ten operations per (branch, state): gather, shift, exp,
            # mask, min, clamp, sum, divide, log2, add
            compare_and_time(
                out, ("marginal_epilogue", label), name, pf_k, out_p[0],
                lambda: kernels.marginal_epilogue(*args),
                lambda: kernels.marginal_epilogue_plain(*args),
                gathered_bytes(*args[:6], torch)
                + nbytes(probv, bvalid, *out_k), 10 * B * M * Np, torch,
                extra_err=list(zip(out_k[1:], out_p[1:])))
        # K4: the sampler's site step at the sampling points (D = 48): the
        # e02 point (128 walkers, one instance and the fleet of 8),
        # chimera-2048's 1024 walkers, and a fleet whose counts of valid
        # states differ; the uniforms are drawn once and shared by both
        # versions, each of which updates its own copy of the walkers
        for nvs, M4, label in (([256], 128, "B1"), ([256] * 8, 128, "B8"),
                               ([256], 1024, "B1_M1024"),
                               ([200, 256, 97, 1, 256, 180, 64, 255], 128,
                                "B8_ragged")):
            a = site_case(gen, nvs, M4, dtype, dev, torch)
            ka, pa = walkers_copy(a), walkers_copy(a)
            RL_k, mPn_k = kernels.sample_site(*(ka[k] for k in SITE_KEYS))
            RL_p, mPn_p = kernels.sample_site_plain(*(pa[k]
                                                      for k in SITE_KEYS))
            nx, col = a["nx"], a["col"]
            ind_k, ind_p = ka["states"][:, :, col], pa["states"][:, :, col]
            what = f"K4 sample_site {name} {label}"
            check(torch.allclose(mPn_k, mPn_p, rtol=rtol, atol=rtol),
                  f"{what}: mPn differs beyond rtol {rtol}")
            draw_args = (a["T2"], a["lBT"], a["drindex"],
                         a["vind"][:, :, nx], a["vind"][:, :, nx + 1],
                         a["nvalid"], a["u"])
            n_bad, unexplained = kernels.sample.draw_mismatches(
                ind_k, ind_p, draw_args)
            limit = 0 if dtype == torch.float64 else 1e-3 * ind_k.numel()
            check(unexplained == 0 and n_bad <= limit,
                  f"{what}: {n_bad} draws differ, {unexplained} of them not "
                  f"at a cumulative boundary")
            check(bool(((ind_k >= 0) & (ind_k < a["nvalid"][:, None])).all()),
                  f"{what}: a draw out of range")
            same = ind_k == ind_p
            check(torch.equal(ka["vind"][same], pa["vind"][same])
                  and torch.equal(ka["states"][same], pa["states"][same]),
                  f"{what}: walker writes differ where the draws agree")
            check(torch.allclose(RL_k[same], RL_p[same], rtol=rtol,
                                 atol=rtol),
                  f"{what}: RL' differs beyond rtol {rtol}")
            check(torch.equal(ka["mq"], mPn_k.amin(dim=1)),
                  f"{what}: mq is not the minimum of the kernel's own mPn")
            print(f"kernel sample_site {name} {label}: {n_bad} of "
                  f"{ind_k.numel()} draws differ from the plain version, "
                  f"all within 64 eps of a cumulative boundary", flush=True)
            D = a["RL"].shape[2]
            Np = a["lBT"].shape[-1]
            # about fifteen operations per (walker, state): gather, shift,
            # exp, mask, min, clamp, sum, divide, scan add, compare, count;
            # and the D x D GEMV's multiply-adds
            compare_and_time(
                out, ("sample_site", label), name, mPn_k, mPn_p,
                lambda: kernels.sample_site(*(ka[k] for k in SITE_KEYS)),
                lambda: kernels.sample_site_plain(*(pa[k]
                                                    for k in SITE_KEYS)),
                site_bytes(a, ka, RL_k, mPn_k, torch),
                len(nvs) * M4 * (15 * Np + 2 * D * D), torch,
                extra_err=[(RL_k[same], RL_p[same])])
    for k, v in out.items():
        for name, cases in v.items():
            for label, r in cases.items():
                sort = (f"  sort alone {r['sort_ms']:.4f} ms"
                        if "sort_ms" in r else "")
                print(f"kernel {k:18s} {name} {label}: wrapper "
                      f"{r['ms']:.4f} ms  device {r['device_ms']:.4f} ms  "
                      f"plain {r['plain_ms']:.4f} ms  bound "
                      f"{r['bound_ms']:.6f} ms ({r['bound_by']})  launch "
                      f"floor {floor:.4f} ms{sort}  max_abs_err "
                      f"{r['max_abs_err']:.3g}", flush=True)
    return out


def ladder_rows(tt, torch, paths, side, betas):
    """The inputs of every row of the float32 'ud' ladder of the
    instances in ``paths`` (one batch), captured on the card: the
    polish's (A0, phi_A, Wc, tol, max_sweeps), K5's, and the absorption's
    (A, lognorm, Wc, omega, tolS), K6's."""
    from tnax_torch import bmps, precondition
    problems = [tt.Solver(mode="Ising", Nx=side, Ny=side, Nc=8,
                          J=tt.round_Jij(tt.Jij_f2p(tt.load_Jij(p)), 1 / 75),
                          beta=3, device="cuda", dtype=torch.float32).problem
                for p in paths]
    rows = {"polish": [], "zipup": []}
    orig, orig_apply = bmps.variational_implicit, bmps.compress_apply

    def capture(mps, phi_A, W, *, conj, tol, max_sweeps):
        rows["polish"].append((mps.A.clone(), phi_A.clone(),
                               bmps._orient_mpo(W, conj).clone(), tol,
                               max_sweeps))
        return orig(mps, phi_A, W, conj=conj, tol=tol, max_sweeps=max_sweeps)

    def capture_apply(mps, W, Dmax, *, conj, tolS, **kw):
        Wc = bmps._orient_mpo(W, conj)
        rows["zipup"].append((mps.A.clone(), mps.lognorm.clone(), Wc.clone(),
                              bmps._zipup_sketch(mps.A, Wc, 2 * Dmax, True,
                                                 kw.get("omega")),
                              max(tolS, torch.finfo(mps.A.dtype).eps)))
        return orig_apply(mps, W, Dmax, conj=conj, tolS=tolS, **kw)

    bmps.variational_implicit = capture
    bmps.compress_apply = capture_apply
    try:
        precondition.precondition_fleet(problems, betas, device="cuda",
                                        dtype=torch.float32)
    finally:
        bmps.variational_implicit = orig
        bmps.compress_apply = orig_apply
    return rows


def polish_ops(L, sweeps):
    """Floating-point operations of K5's polish of one lane of L sites
    that ran ``sweeps`` passes: per site step the 64 x 256 x 256 product
    and three 131,072-FMA contractions (X, projection, environment
    update; the left environments of A0 skip the projection), two each
    per FMA; the QR and the SVD are left out (under 1%)."""
    prod, small = 64 * 256 * 256, 8 * 16 * 8 * 128
    return 2 * (L * (prod + 2 * small)
                + int(sweeps) * (2 * L - 1) * (prod + 3 * small))


def polish_checks(tt, torch, floor):
    """Phase 2, K5: the ladder's polish in one launch against the plain
    polish on the card, float32, on every row of the chimera-2048 ladder
    (two rungs, two lanes a row: B1) and of the eight chimera-512
    instances' (one rung, 16 lanes: B8). Lanes whose sweeps are equal:
    the states agree to a fidelity of 1 - 1e-6 and ln_state to 1e-4;
    the lanes apart are counted (float32's stop sits on rounding noise,
    tests/test_torch_gpu.py), and the most sweeps a row, summed, agree
    within half a pass a row; the whole ladder's polish time of both
    (CUDA events around each call); then on the row of the most passes
    the kernel's wrapper and device times, the plain version's and the
    bound (its operations at the FP32 rate: K5 uses one SM a lane)."""
    from tnax_torch import bmps, kernels
    cases = (("B1", [INSTANCE], 16, [1.5, 3.0]),
             ("B8", [f + ".txt" for f in FLEET], 8, [3.0]))
    out = {}
    for label, paths, side, betas in cases:
        rows = ladder_rows(tt, torch, paths, side, betas)["polish"]
        tot = {"k5": 0.0, "plain": 0.0}
        passes = {"k5": 0, "plain": 0}
        unequal = apart = 0
        best = None
        for A0, phi_A, Wc, tol, ms in rows:
            res = {}
            for side_, fn in (("k5", kernels.polish_row),
                              ("plain", kernels.polish_row_plain)):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                res[side_] = fn(A0, phi_A, Wc, tol=tol, max_sweeps=ms)
                b.record()
                b.synchronize()
                tot[side_] += a.elapsed_time(b)
                passes[side_] += int(res[side_][3].max())
            (Ak, _, lk, sk), (Ap, _, lp, sp) = res["k5"], res["plain"]
            unequal += int((sk != sp).sum())
            apart = max(apart, int((sk - sp).abs().max()))
            same = sk == sp
            fid = (bmps.mps_dot(Ak.double(), Ap.double()).abs()
                   / torch.sqrt(bmps.mps_dot(Ak.double(), Ak.double())
                                * bmps.mps_dot(Ap.double(), Ap.double())))
            check(bool((fid[same] > 1 - 1e-6).all())
                  and bool(((lk - lp).abs()[same] <= 1e-4).all()),
                  f"K5 {label}: states or ln_state differ")
            if best is None or int(sk.max()) > int(best[4][3].max()):
                best = (A0, phi_A, Wc, tol, res["k5"], ms)
        check(abs(passes["k5"] - passes["plain"]) <= 0.5 * len(rows),
              f"K5 {label}: passes {passes['k5']} vs {passes['plain']} over "
              f"{len(rows)} rows")
        A0, phi_A, Wc, tol, got, ms = best
        L = A0.shape[1]
        ops = sum(polish_ops(L, s) for s in got[3].tolist())
        moved = nbytes(A0, phi_A, Wc, got[0])
        want = kernels.polish_row_plain(A0, phi_A, Wc, tol=tol, max_sweeps=ms)
        same = got[3] == want[3]     # max_abs_err over lanes of equal sweeps
        compare_and_time(
            out, ("polish", label), "float32", got[0][same], want[0][same],
            lambda: kernels.polish_row(A0, phi_A, Wc, tol=tol, max_sweeps=ms),
            lambda: kernels.polish_row_plain(A0, phi_A, Wc, tol=tol,
                                             max_sweeps=ms),
            moved, ops, torch,
            extra=dict(rows=len(rows), lanes=A0.shape[0], sites=L,
                       ladder_k5_ms=tot["k5"], ladder_plain_ms=tot["plain"],
                       passes_k5=passes["k5"], passes_plain=passes["plain"],
                       lanes_apart=unequal, most_passes_apart=apart,
                       row_sweeps=got[3].tolist()))
        r = out["polish"]["float32"][label]
        print(f"kernel polish {label}: {len(rows)} rows x {A0.shape[0]} "
              f"lanes, L={L}: the ladder's polish K5 {tot['k5']:.1f} ms vs "
              f"plain {tot['plain']:.1f} ms; passes (most a row, summed) "
              f"{passes['k5']} vs {passes['plain']}, {unequal} lane-rows "
              f"apart (by up to {apart}); the row of {got[3].tolist()} "
              f"sweeps: "
              f"wrapper {r['ms']:.3f} ms  device {r['device_ms']:.3f} ms  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})  launch floor {floor:.4f} ms  max_abs_err "
              f"{r['max_abs_err']:.3g}", flush=True)
    return out


def zipup_ops(L):
    """Floating-point operations of K6 on one lane of L sites, two per
    FMA: per site the 128 x 256 x 256 product of T A with W and the T A
    slices, the sketch's six 256 x 128 x 48 products, the site's U
    (256 x 48 x 16) and the truncation sweep's small contractions; the
    five sketch QRs and the two canonizations' QRs (factorization and Q,
    4 m n^2 - 4 n^3 / 3 each). The Jacobi SVDs are left out: their sweeps
    depend on the data, so this is a floor."""
    def qr(m, n):
        return 4 * m * n * n - 4 * n ** 3 // 3
    fma = (128 * 256 * 256 + 16 * 2048 * 8 + 6 * 256 * 128 * 48
           + 256 * 48 * 16 + 4096 * 16 + 1024 * 16 + 1024 * 8)
    return L * (2 * fma + 3 * qr(256, 48) + 2 * qr(128, 48) + qr(256, 16)
                + qr(128, 8))


def k7_calls(stages):
    """K7's calls as the stage clock counted them: the ``#svd_k7``
    counters of every key of ``stages``."""
    return sum(v for k, v in stages.items() if k.endswith("#svd_k7"))


def zipup_checks(tt, torch, floor):
    """Phase 2, K6: the ladder's zip-up and truncation sweep in one
    launch against the plain steps on the card, float32, on every row of
    the chimera-2048 ladder (two rungs, two lanes a row: B1) and of the
    eight chimera-512 instances' (one rung, 16 lanes: B8): the
    right-canonized input to 1e-5 and its lognorm to 1e-4, the truncated
    zip-up as a state to a fidelity of 1 - 1e-5; the whole ladder's time
    of both (CUDA events around each call); then on the middle row the
    kernel's wrapper and device times, the plain version's and the bound
    (:func:`zipup_ops` at the FP32 rate: K6 uses one SM a lane)."""
    from tnax_torch import bmps, kernels
    cases = (("B1", [INSTANCE], 16, [1.5, 3.0]),
             ("B8", [f + ".txt" for f in FLEET], 8, [3.0]))
    out = {}
    for label, paths, side, betas in cases:
        rows = ladder_rows(tt, torch, paths, side, betas)["zipup"]
        tot = {"k6": 0.0, "plain": 0.0}
        infid = dphi = dln = 0.0
        for A, ln, Wc, om, tolS in rows:
            res = {}
            for side_, fn in (("k6", kernels.zipup_row),
                              ("plain", kernels.zipup_row_plain)):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                res[side_] = fn(A, ln, Wc, om, tolS=tolS)
                b.record()
                b.synchronize()
                tot[side_] += a.elapsed_time(b)
            got, want = res["k6"], res["plain"]
            x, y = got[2].double(), want[2].double()
            fid = (bmps.mps_dot(x, y).abs()
                   / torch.sqrt(bmps.mps_dot(x, x) * bmps.mps_dot(y, y)))
            infid = max(infid, float((1 - fid).max()))
            dphi = max(dphi, float((got[0] - want[0]).abs().max()))
            dln = max(dln, float((got[1] - want[1]).abs().max()))
        check(infid < 1e-5 and dphi <= 1e-5 and dln <= 1e-4,
              f"K6 {label}: 1 - fidelity {infid:.3g}, |d phi| {dphi:.3g}, "
              f"|d lognorm| {dln:.3g}")
        A, ln, Wc, om, tolS = rows[len(rows) // 2]
        B, L = A.shape[:2]
        got = kernels.zipup_row(A, ln, Wc, om, tolS=tolS)
        want = kernels.zipup_row_plain(A, ln, Wc, om, tolS=tolS)
        moved = nbytes(A, Wc, om, got[0], got[2]) + 2 * B * L * 4096 * 4
        compare_and_time(
            out, ("zipup", label), "float32", got[0], want[0],
            lambda: kernels.zipup_row(A, ln, Wc, om, tolS=tolS),
            lambda: kernels.zipup_row_plain(A, ln, Wc, om, tolS=tolS),
            moved, B * zipup_ops(L), torch,
            extra=dict(rows=len(rows), lanes=B, sites=L,
                       ladder_k6_ms=tot["k6"], ladder_plain_ms=tot["plain"],
                       worst_infidelity=infid))
        r = out["zipup"]["float32"][label]
        print(f"kernel zipup {label}: {len(rows)} rows x {B} lanes, L={L}: "
              f"the ladder's zip-up K6 {tot['k6']:.1f} ms vs plain "
              f"{tot['plain']:.1f} ms; worst 1 - fidelity {infid:.3g}, "
              f"|d phi| {dphi:.3g}; a row: wrapper {r['ms']:.3f} ms  device "
              f"{r['device_ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})  launch floor "
              f"{floor:.4f} ms  max_abs_err {r['max_abs_err']:.3g}",
              flush=True)
    return out


def svd_ops(p, q, vectors, whole, sweeps):
    """Floating-point operations of K7 on one matrix (p = min(m, n), q =
    max(m, n)) whose Jacobi ran ``sweeps`` sweeps, two per FMA: the QR's
    2 q p^2 - 2 p^3 / 3; each sweep's p (p - 1) / 2 pairs, three sums and
    a rotation over p rows (12 p), and the rotation of J's rows (6 p)
    where the whole path accumulates it; then V, Q1 J (4 q p^2) on the
    whole path or the product X^T U (2 p^2 q) on the streamed one."""
    qr = 2 * q * p * p - 2 * p ** 3 // 3
    pair = 12 * p + (6 * p if vectors and whole else 0)
    out = (4 * q * p * p if whole else 2 * p * p * q) if vectors else 0
    return qr + sweeps * p * (p - 1) // 2 * pair + out


# K7's cases: (label, shape, whole path, svd or svdvals), the boundary's
# SVDs at Dmax 48 (chimera-2048) and 32 (chimera-512)
SVD_CASES = (("core48", (128, 768), False, True),
             ("trunc48", (96, 96), True, True),
             ("polish48", (48, 48), True, False),
             ("core32", (96, 512), False, True),
             ("trunc32", (64, 64), True, True),
             ("polish32", (32, 32), True, False))


def boundary_matrices(tt, torch, path, side, Dmax):
    """Every matrix a float32 boundary build at Dmax hands to K7, after
    the Solver's ladder, by shape."""
    from tnax_torch import bmps
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(path)), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=side, Ny=side, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float32)
    ins.precondition()
    out, orig = {}, bmps._svd_k7

    def take(M, vectors):
        out.setdefault(tuple(M.shape[-2:]), []).append(M.clone())
        return orig(M, vectors)

    bmps._svd_k7 = take
    try:
        ins._context().build_boundary(Dmax, 1e-16, 1e-10, 20)
    finally:
        bmps._svd_k7 = orig
    return out


def svd_checks(tt, torch, floor):
    """Phase 2, K7: the boundary's SVDs at Dmax 48 (chimera-2048) and 32
    (chimera-512 s1), on matrices captured from the float32 builds: B1
    the middle one of a shape, B8 the eight around it. S against a
    float64 SVD to 32 sqrt(p) eps of S[0], U S Vh against M to as much
    of ||M||, the svdvals entry's S likewise and equal to svd's, bit for
    bit; the sweeps; the wrapper's and device times (CUDA graph),
    torch.linalg.svd's (the library, which reads its info on the host)
    and the bound (:func:`svd_ops` at the FP32 rate)."""
    from tnax_torch import bmps, kernels
    eps = torch.finfo(torch.float32).eps
    mats = {48: boundary_matrices(tt, torch, INSTANCE, 16, 48),
            32: boundary_matrices(tt, torch, FLEET[0] + ".txt", 8, 32)}
    out = {}
    for label, shape, whole, vectors in SVD_CASES:
        got_all = mats[int(label[-2:])][shape]
        mid = len(got_all) // 2
        for bl, Ms in (("B1", got_all[mid:mid + 1]),
                       ("B8", got_all[max(0, mid - 4):max(0, mid - 4) + 8])):
            M = torch.cat(Ms)
            B, p = M.shape[0], min(shape)
            sweeps = torch.zeros(B, dtype=torch.int32, device=M.device)
            U, S, Vh = kernels.svd.svd_fixed(M, sweeps=sweeps)
            vals = kernels.svd.svdvals(M)
            S64 = torch.linalg.svdvals(M.double())
            s0 = S64[:, :1].clamp(min=1e-300)
            ds = float(((S.double() - S64).abs() / s0).max())
            dv = float(((vals.double() - S64).abs() / s0).max())
            rec = float((torch.linalg.norm(
                (U.double() * S.double()[:, None]) @ Vh.double()
                - M.double(), dim=(1, 2))
                / torch.linalg.norm(M.double(), dim=(1, 2)).clamp(
                    min=1e-300)).max())
            tol = 32 * p ** 0.5 * eps
            check(ds <= tol and rec <= tol and dv <= tol
                  and torch.equal(vals, S),
                  f"K7 {label} {bl}: |dS|/S0 {ds:.3g}, |USVh - M|/|M| "
                  f"{rec:.3g}, svdvals |dS|/S0 {dv:.3g} and equal to svd's "
                  f"S: {torch.equal(vals, S)}, tol {tol:.3g}")
            sw = sweeps.tolist()
            ops = sum(svd_ops(p, max(shape), vectors, whole, k) for k in sw)
            if vectors:
                kern = lambda: kernels.svd.svd_fixed(M)
                lib = lambda: torch.linalg.svd(M, full_matrices=False)
                plain = lambda: bmps.svd_fixed_plain(M)
            else:
                kern = lambda: kernels.svd.svdvals(M)
                lib = plain = lambda: torch.linalg.svdvals(M)
            bms, by = bound(nbytes(M, U, Vh), ops, "float32")
            r = dict(max_abs_err=float((S.double() - S64).abs().max()),
                     max_rel_err_S=ds, rel_err_USVh=rec, sweeps=sw,
                     ms=median_ms(kern, torch),
                     device_ms=device_ms(kern, torch),
                     plain_ms=median_ms(plain, torch),
                     library_ms=median_ms(lib, torch), bound_ms=bms,
                     bound_by=by, matrices=len(got_all))
            out.setdefault("svd", {}).setdefault("float32", {})[
                f"{label}_{bl}"] = r
            print(f"kernel svd {label} {bl} {tuple(M.shape)}: sweeps {sw}  "
                  f"wrapper {r['ms']:.4f} ms  device {r['device_ms']:.4f} "
                  f"ms  plain {r['plain_ms']:.4f} ms  library "
                  f"{r['library_ms']:.4f} ms  bound {bms:.6f} ms ({by})  "
                  f"launch floor {floor:.4f} ms  |dS|/S0 {ds:.3g}  "
                  f"|USVh - M|/|M| {rec:.3g}  ({len(got_all)} such "
                  f"matrices a build)", flush=True)
    out["svd"]["float32"]["B8"] = out["svd"]["float32"]["core48_B8"]
    return out


def launch_floor_ms(torch, dev):
    """Median time of one launch of a one-element kernel: the floor that
    every kernel launch pays, whatever its work."""
    x = torch.zeros(1, device=dev)
    return median_ms(lambda: x.add_(1.0), torch)


def recheck(tt, J, ins, states):
    ins.states = states[None, :][:, ins.order]
    return float(tt.energy_Jij(J, ins.binary_states())[0])


def slice_run(tt, torch, J, oracle, dtype, label, cand_factor=8):
    """One flagship search at the merge cap ``cand_factor`` * M (None: the
    full expansion); returns (seconds, stage times, result, recomputed
    energy, launch counts of this run)."""
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
        Dmax=oracle["Dmax"], cand_factor=cand_factor, stage_times=stages)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    E = recheck(tt, J, ins, res["states"])
    print(f"slice {label}: {seconds:.3f} s  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f"  energy {res['energy']:.6f} recheck {E:.6f} oracle "
          f"{oracle['energy']:.6f}  deg {res['degeneracy']} (oracle "
          f"{oracle['degeneracy']})  merge_overflow "
          f"{res['merge_overflow']}  count_max {res['count_max']}  "
          f"launches {counts}", flush=True)
    for k in SEARCH_KERNELS:
        check(counts[k] > 0, f"slice {label}: kernel {k} was not launched")
    check(counts["sample_site"] == 0, f"slice {label}: the search drew")
    return seconds, stages, res, E, counts


def full_phase(tt, torch, J):
    """Phase 3, second part: the chimera-2048 search at the full expansion
    (cand_factor=None, the uncapped exact merge of tnax), float64 once and
    float32 cold and warm. Gates every energy on its recheck, the
    merge on no overflow and on one K2 and one K3 launch per site, and the
    float64 energy on the committed tnax oracle of the full expansion."""
    with open(FULL_ORACLE) as f:
        oracle = json.load(f)
    sites = oracle["Nx"] * oracle["Ny"]
    runs = {}
    for dtype, label in ((torch.float64, "full f64"),
                         (torch.float32, "full f32 cold"),
                         (torch.float32, "full f32 warm")):
        runs[label] = slice_run(tt, torch, J, oracle, dtype, label,
                                cand_factor=None)
        _, _, res, E, counts = runs[label]
        check(abs(res["energy"] - E) <= 1e-9,
              f"{label}: returned energy {res['energy']} != recheck {E}")
        check(res["merge_overflow"] == 0,
              f"{label}: merge_overflow {res['merge_overflow']}")
        for k in ("merge", "marginal_epilogue"):
            check(counts[k] == sites, f"{label}: kernel {k} launched "
                  f"{counts[k]} times, want one per site ({sites})")
        if dtype == torch.float64:
            check(E <= oracle["energy"] + 1e-6,
                  f"{label}: energy {E} above the full-expansion oracle "
                  f"{oracle['energy']}")
    print(f"full f32 warm {runs['full f32 warm'][0]:.3f} s; count_max "
          f"{runs['full f64'][2]['count_max']} (oracle "
          f"{oracle['count_max']})", flush=True)


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
    runs = {}
    for dtype, labels in ((torch.float64, ["f64"]),
                          (torch.float32, ["f32 cold", "f32 warm 1",
                                           "f32 warm 2", "f32 warm 3"])):
        for label in labels:
            runs[label] = fleet_run(tt, torch, Js, oracles, dtype, label)
            _, stages, rs, Es, counts = runs[label]
            # pre_steps = 1; K6 and K5 run each float32 ladder row
            k56 = o["Ny"] if dtype == torch.float32 else 0
            # K7 takes every float32 SVD of the D=48 boundary
            want = dict(gebal=2 * o["Nx"], merge=o["Nx"] * o["Ny"],
                        marginal_epilogue=o["Nx"] * o["Ny"], sample_site=0,
                        polish=k56, zipup=k56,
                        svd=k7_calls(stages))
            check(counts == want and (counts["svd"] > 0) == (k56 > 0),
                  f"fleet {label}: launches {counts}, want {want} (one per "
                  f"site, sweep step or ladder row per batch; K7 once per "
                  f"float32 boundary SVD the stage clock counted)")
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


def sample_run(tt, torch, Js, n, dtype, label, M, seed=0, uniforms=None):
    """One pass of the sampler over the chimera instances ``Js`` of n x n
    cells (a fleet when there are several) at beta=3; returns (seconds, stage times, results,
    launch counts of this run). Gates every sampled energy on its
    decoded state and the launches of K1 and K4 on one per interface
    sweep step and per site."""
    from tnax_torch import kernels
    solvers = [tt.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, J=J, beta=3,
                         device="cuda", dtype=dtype) for J in Js]
    stages = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rs = tt.multi_flagship_sample(solvers, M=M, seed=seed, uniforms=uniforms,
                                  stage_times=stages, **SAMPLE_KW)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    B = len(Js)
    print(f"sample {label}: {seconds:.3f} s  {B * M / seconds:.1f} samples/s"
          f"  {60 * B / seconds:.2f} instances/min  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f"  launches {counts}  lowest "
          + " ".join(f"{float(r['energy'].min()):.6f}" for r in rs)
          + "  negative_probability "
          + " ".join(f"{r['negative_probability']:.3g}" for r in rs),
          flush=True)
    k56 = SAMPLE_KW["pre_steps"] * n if dtype == torch.float32 else 0
    want = dict(gebal=2 * SAMPLE_KW["pre_steps"] * n, merge=0,
                marginal_epilogue=0, sample_site=n * n, polish=k56,
                zipup=k56, svd=k7_calls(stages))
    check(counts == want and (counts["svd"] > 0) == (k56 > 0),
          f"sample {label}: launches {counts}, want {want} (K4 once per "
          f"site, K1 once per interface sweep step, K6 and K5 once per "
          f"float32 ladder row, K7 once per float32 boundary SVD the "
          f"stage clock counted)")
    for J, ins, r in zip(Js, solvers, rs):
        ins.states = r["states"][:, ins.order]
        E = tt.energy_Jij(J, ins.binary_states())
        err = float(abs(r["energy"] - E).max())
        check(r["states"].shape == (M, n * n) and err <= 1e-9,
              f"sample {label}: energies differ from energy_Jij of the "
              f"states by {err}")
    return seconds, stages, rs, counts


def sample_phase(tt, torch):
    """Phase 5: Gibbs sampling through its entry points at the e02 point
    (single s1 and the fleet of 8) and at chimera-2048; returns the
    launch counts of the last float32 fleet pass."""
    import numpy as np
    from tnax_torch import parallel
    Js = [tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")), 1 / 75)
          for base in FLEET]
    search = []
    for base in FLEET:
        with open(base + "_oracle.json") as f:
            search.append(json.load(f)["energy"])
    with open(SAMPLE_ORACLE) as f:
        orc = json.load(f)
    # the f64 mean against tnax's: two independent samples of the same
    # distribution, 128 and N walkers
    tol = 5 * orc["std"] * (1 / E02_M + 1 / orc["N"]) ** 0.5

    def gate_mean(label, E):
        mean = float(np.mean(E))
        print(f"  {label}: mean energy {mean:.6f} (tnax oracle "
              f"{orc['mean']:.6f}, tolerance {tol:.6f}), std "
              f"{float(np.std(E, ddof=1)):.6f}", flush=True)
        return mean

    def lowest(label, rs, oracles):
        for r, o, name in zip(rs, oracles, FLEET):
            lo = float(r["energy"].min())
            note = "  below the search oracle" if lo < o - 1e-6 else ""
            print(f"  {label} {os.path.basename(name)}: lowest sampled "
                  f"{lo:.6f}, search oracle {o:.6f}{note}", flush=True)

    out = {}
    for group, Jg, seed, n_warm in (("e02 single", Js[:1], 0, 3),
                                    ("e02 fleet", Js, FLEET_SEED, 1)):
        runs = {}
        warm = [f"f32 warm {i}" for i in range(1, n_warm + 1)]
        for dtype, label in ([(torch.float64, "f64"),
                              (torch.float32, "f32 cold")]
                             + [(torch.float32, w) for w in warm]):
            runs[label] = sample_run(tt, torch, Jg, 8, dtype,
                                     f"{group} {label}", E02_M, seed=seed)
            mean = gate_mean(f"{group} {label} s1", runs[label][2][0]
                             ["energy"])
            if dtype == torch.float64:
                check(abs(mean - orc["mean"]) <= tol,
                      f"{group} f64: mean energy {mean} on s1 is more than "
                      f"{tol} from the tnax oracle {orc['mean']}")
        lowest(group, runs[warm[-1]][2], search)
        secs = [runs[w][0] for w in warm]
        med = statistics.median(secs)
        print(f"{group} f32 warm median {med:.3f} s, spread "
              f"{max(secs) - min(secs):.3f} s, "
              f"{len(Jg) * E02_M / med:.1f} samples/s, "
              f"{60 * len(Jg) / med:.2f} instances/min", flush=True)
        out[group] = runs
    # the f32 fleet against single runs of its first two instances on the
    # same uniforms (printed: batched cuSOLVER calls may round otherwise
    # than single ones)
    fleet_rs = out["e02 fleet"]["f32 warm 1"][2][:2]
    same, t0 = 0, time.perf_counter()
    for b, (J, rf) in enumerate(zip(Js, fleet_rs)):
        u = parallel.instance_uniforms(FLEET_SEED, b, (8, 8, E02_M),
                                       torch.float32, "cuda")
        r1 = sample_run(tt, torch, [J], 8, torch.float32,
                        f"single f32 s{b + 1}", E02_M, uniforms=u[None])[2][0]
        agree = int((r1["states"] == rf["states"]).all(axis=1).sum())
        same += agree == E02_M
        print(f"  s{b + 1}: {agree} of {E02_M} walkers as in the fleet; "
              f"mean {float(r1['energy'].mean()):.6f} fleet "
              f"{float(rf['energy'].mean()):.6f}", flush=True)
    print(f"f32 e02 fleet vs single runs on the same uniforms: {same} of "
          f"{len(fleet_rs)} instances agree in every walker; "
          f"{len(fleet_rs)} single runs {time.perf_counter() - t0:.3f} s",
          flush=True)
    # chimera-2048, 1024 walkers: float32 and float64 passes with every
    # draw examined
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)
    with open(ORACLE) as f:
        E_gs = json.load(f)["energy"]
    for dtype, label in ((torch.float32, "f32 examined"),
                         (torch.float64, "f64 examined")):
        undo = examine_draws(tt, torch, 16, f"chimera-2048 {label}")
        try:
            r = sample_run(tt, torch, [J], 16, dtype,
                           f"chimera-2048 {label}", E2048_M)[2][0]
        finally:
            uniform = undo()
        print(f"  chimera-2048 {label}: mean energy "
              f"{float(r['energy'].mean()):.6f}, lowest sampled "
              f"{float(r['energy'].min()):.6f}, search oracle {E_gs:.6f}, "
              f"negative_probability {r['negative_probability']:.3g}",
              flush=True)
        # float32's boundary noise may saturate a walker's marginals (tnax
        # shows it too); float64 must not
        if dtype == torch.float64:
            check(uniform == 0 and r["negative_probability"] > -1,
                  f"chimera-2048 {label}: {uniform} draws from the uniform "
                  f"row, negative_probability {r['negative_probability']}")
    return out["e02 fleet"]["f32 warm 1"][3]


def examine_draws(tt, torch, Nx, label):
    """Watch K4's draws in the sampler for one pass: after each site's
    step, recompute the site's marginals with the plain version on the
    same inputs and count what went wrong. Returns the function that stops
    watching, prints the pass's counts (the walkers that drew from the
    uniform row, mPn = -1, by cause, and the draws of a state whose
    marginal is 0) and returns the number of draws from the uniform row."""
    from tnax_torch import parallel
    from tnax_torch.kernels.marginal import _pn_from_columns, columns
    site = parallel.sample_site
    rows, tainted = [], []

    def watched(T2, lBT, drindex, dmap, rmap, nvalid, u, AT, RL, vind,
                states, nx, col_s, mq):
        lidx, uidx = vind[:, :, nx].clone(), vind[:, :, nx + 1].clone()
        out = site(T2, lBT, drindex, dmap, rmap, nvalid, u, AT, RL, vind,
                   states, nx, col_s, mq)
        mPn, indc = out[1], states[:, :, col_s]
        B, M = mPn.shape
        Np = lBT.shape[-1]
        col = columns(lBT, lidx, uidx)
        Pn = _pn_from_columns(T2, col, drindex, nvalid)[0]
        valid = torch.arange(Np, device=Pn.device) < nvalid[:, None, None]
        top = (nvalid.long() - 1)[:, None, None].expand(B, M, 1)
        above = torch.cumsum(Pn, 2).gather(2, top)[..., 0] < u
        fb = mPn == -1
        zero = (Pn.gather(2, indc.long()[..., None])[..., 0] == 0) & ~fb
        g = T2.gather(2, drindex.long()[:, None, :].expand(B, M, Np))
        shift = col.amax(2, keepdim=True)
        x = col - torch.where(torch.isfinite(shift), shift, 0.0)
        finite = ((torch.isfinite(g) | ~valid).all(2)
                  & ~torch.isnan(col).any(2))
        g_zero = ((g == 0) | ~valid).all(2)
        p = g * torch.exp(x)
        live = ((p != 0) & valid).any(2)
        live64 = ((g.double() * torch.exp(x.double()) != 0) & valid).any(2)
        # saturated: the most negative marginal outweighs every valid one,
        # so all are clamped to it and the row is uniform
        pmin = torch.where(valid, p, float("inf")).amin(2, keepdim=True)
        saturated = (pmin[..., 0] < 0) & ((p <= pmin.abs()) | ~valid).all(2)
        if not tainted:
            tainted.append(torch.zeros_like(fb))
        rows.append(torch.stack([
            fb.sum(), (fb & tainted[0]).sum(), (fb & ~finite).sum(),
            (fb & g_zero).sum(), (fb & ~live & live64).sum(),
            (fb & saturated).sum(), zero.sum(), (zero & above).sum(),
            above.sum()]))
        tainted[0] |= zero
        return out

    def undo():
        parallel.sample_site = site
        c = torch.stack(rows).cpu()
        tot = c.sum(0).tolist()

        def first(k):
            hit = c[:, k].nonzero()
            return divmod(int(hit[0]), Nx) if len(hit) else None
        print(f"  {label} draws: {len(rows)} sites; {tot[0]} draws from the "
              f"uniform row ({tot[5]} saturated: the most negative marginal "
              f"outweighs every valid one; {tot[1]} after an earlier "
              f"zero-probability draw of the walker, {tot[2]} with "
              f"non-finite inputs, {tot[3]} with T2 zero at every valid "
              f"state, {tot[4]} where every product underflows the dtype "
              f"but not float64), first at site (ny, nx) {first(0)}, by "
              f"lattice row {c[:, 0].reshape(-1, Nx).sum(1).tolist()}; "
              f"{tot[6]} draws of a state whose marginal is 0 ({tot[7]} "
              f"with u above the last cumulative sum), first at "
              f"{first(6)}; {tot[8]} draws with u above the last cumulative "
              f"sum", flush=True)
        return tot[0]
    parallel.sample_site = watched
    return undo


def noisy_couplings(ins):
    """The couplings the Solver holds (after add_noise) as [i, j, Jij]
    triples, for ``energy_Jij``."""
    import scipy.sparse
    return [[int(i), int(j), float(v)]
            for i, j, v in zip(*scipy.sparse.find(ins.problem.J))]


def spectrum_run(tt, torch, J, n, dtype, label, *, ee, M, Dmax,
                 cand_factor, noise=False, precondition=False,
                 zipup_rsvd=None):
    """One low-energy spectrum through the Solver's entry points
    (add_noise, precondition, search_low_energy_spectrum with auto_grow,
    decode_low_energy_states) on a chimera instance of n x n cells at
    beta=3, cutoff 1e-8, max_dEng=1.0. Gates every decoded energy on
    ``energy_Jij`` of its state under the Solver's couplings (1e-9), the
    decoded states on being distinct and sorted by energy, and K2 and K3
    on one launch per site and pass. Returns (seconds, stage times,
    Solver, launch counts of this run, noise bound)."""
    import numpy as np
    from tnax_torch import kernels
    ins = tt.Solver(mode="Ising", Nx=n, Ny=n, Nc=8, J=J, beta=3,
                    device="cuda", dtype=dtype)
    bound = 0.0
    if noise:
        np.random.seed(7)
        ins.add_noise(1e-7)
        # each perturbed coupling moves an energy by at most 1e-7
        bound = 1e-7 * ins.problem.J.count_nonzero()
    stages = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if precondition:
        ins.precondition(stage_times=stages)
    ins.search_low_energy_spectrum(
        excitations_encoding=ee, M=M, relative_P_cutoff=1e-8, Dmax=Dmax,
        max_dEng=1.0, path="device", cand_factor=cand_factor,
        zipup_rsvd=zipup_rsvd, stage_times=stages)
    t1 = time.perf_counter()
    ins.decode_low_energy_states(max_dEng=1.0)
    seconds = time.perf_counter() - t0
    stages["decode"] = time.perf_counter() - t1
    counts = kernels.launch_counts()
    E = tt.energy_Jij(noisy_couplings(ins), ins.binary_states())
    err = float(abs(E - ins.energy).max())
    print(f"spectrum {label}: {seconds:.3f} s  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f"  passes (cand_factor, merge_overflow, count_max) "
          f"{ins.spectrum_passes}  final cap {ins.cand_factor} x M  "
          f"{len(ins.energy)} states, lowest {ins.energy[0]:.9f}, "
          f"degeneracy {ins.degeneracy}, recheck error {err:.3g}  "
          f"negative_probability {ins.negative_probability:.3g}  launches "
          f"{counts}", flush=True)
    check(err <= 1e-9, f"spectrum {label}: decoded energies differ from "
          f"energy_Jij of their states by {err}")
    check(len({s.tobytes() for s in ins.states}) == len(ins.states)
          and bool((np.diff(ins.energy) >= 0).all()),
          f"spectrum {label}: decoded states not distinct and sorted")
    sites = n * n * len(ins.spectrum_passes)
    for k in ("merge", "marginal_epilogue"):
        check(counts[k] == sites, f"spectrum {label}: kernel {k} launched "
              f"{counts[k]} times, want one per site and pass ({sites})")
    check(counts["sample_site"] == 0, f"spectrum {label}: the search drew")
    check((counts["gebal"] > 0) == precondition,
          f"spectrum {label}: K1 launched {counts['gebal']} times")
    return seconds, stages, ins, counts, bound


def sorted_pairs(E, S):
    """Decoded (energies, states) sorted by energy (to 1e-9), then state:
    the order in which two lists of degenerate states compare."""
    import numpy as np
    order = np.lexsort(tuple(np.asarray(S).T[::-1]) + (np.round(E, 9),))
    return np.asarray(E)[order], np.asarray(S)[order]


def spectrum_phase(tt, torch):
    """Phase 6: the low-energy spectrum through the Solver's entry points.
    (a) chimera-128 in float64, exact-SVD zip-up, held to the committed
    tnax oracle (ee=1, and ee=2 after noise), then a float32 ee=1; (b)
    chimera-2048 at bench.py's spectrum point (noise, precondition, ee=2,
    M=1024, D=32, cand_factor=64 with auto_grow), float32, then float64;
    (c) the fleet of 8 chimera-512 through
    multi_search_spectrum, float32, ee=1, once. Returns the
    launch counts of the float32 chimera-2048 run."""
    import numpy as np
    with open(SPECTRUM_ORACLE) as f:
        orc = json.load(f)
    J128 = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(os.path.join(
        DATA, orc["instance"]))), 1 / 75)

    # (a) parity with tnax's oracle on the card
    for run in orc["runs"]:
        ee = run["excitations_encoding"]
        _, _, ins, _, _ = spectrum_run(
            tt, torch, J128, 4, torch.float64, f"chimera-128 f64 ee={ee}",
            ee=ee, M=orc["M"], Dmax=orc["Dmax"],
            cand_factor=orc["initial_cand_factor"], noise=ee > 1,
            zipup_rsvd=orc["zipup_rsvd"])
        E_o = np.asarray(run["energies"])
        ok = len(ins.energy) == len(E_o) and bool(
            np.abs(np.sort(ins.energy) - np.sort(E_o)).max() <= 1e-9)
        same = ok and all(np.array_equal(a, b) for a, b in zip(
            sorted_pairs(ins.energy, ins.states),
            sorted_pairs(E_o, run["states"])))
        print(f"  chimera-128 f64 ee={ee}: {len(ins.energy)} states "
              f"(oracle {len(E_o)}), degeneracy {ins.degeneracy} (oracle "
              f"{run['degeneracy']}), passes {ins.spectrum_passes} (oracle "
              f"{run['passes']}); the same set of states as the oracle: "
              f"{same}", flush=True)
        check(ok, f"chimera-128 f64 ee={ee}: decoded energies differ from "
              f"the tnax oracle's")
    run = orc["runs"][0]
    _, _, ins, _, _ = spectrum_run(
        tt, torch, J128, 4, torch.float32, "chimera-128 f32 ee=1", ee=1,
        M=orc["M"], Dmax=orc["Dmax"], cand_factor=orc["initial_cand_factor"],
        zipup_rsvd=orc["zipup_rsvd"])
    common = len({s.tobytes() for s in ins.states.astype(np.int32)}
                 & {s.tobytes() for s in np.asarray(run["states"],
                                                    np.int32)})
    print(f"  chimera-128 f32 ee=1: {common} of {len(run['states'])} oracle "
          f"states decoded ({len(ins.energy)} states)", flush=True)
    check(ins.energy[0] <= run["energies"][0] + 1e-9,
          f"chimera-128 f32 ee=1: lowest {ins.energy[0]} above the oracle's "
          f"{run['energies'][0]}")

    # (b) chimera-2048 at bench.py's spectrum point
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)
    with open(ORACLE) as f:
        E_gs = json.load(f)["energy"]
    runs = {}
    for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
        runs[label] = spectrum_run(
            tt, torch, J, 16, dtype, f"chimera-2048 {label}", ee=2, M=1024,
            Dmax=32, cand_factor=64, noise=True, precondition=True)
        _, _, ins, _, bound = runs[label]
        near = int((ins.energy <= ins.energy[0] + 2 * bound).sum())
        print(f"  chimera-2048 {label}: lowest {ins.energy[0]:.9f} (GS "
              f"oracle {E_gs}, noise bound {bound:.3g}); {near} states "
              f"within twice the bound of the lowest", flush=True)
        check(ins.merge_overflow == 0, f"chimera-2048 {label}: "
              f"merge_overflow {ins.merge_overflow}")
        check(abs(ins.energy[0] - E_gs) <= bound,
              f"chimera-2048 {label}: lowest {ins.energy[0]} not within "
              f"{bound} of the oracle {E_gs}")
        if dtype == torch.float64:
            check(near >= 2, f"chimera-2048 {label}: {near} states within "
                  f"{2 * bound} of the lowest, the oracle's degeneracy is 2")

    # (c) the fleet of 8 chimera-512 through multi_search_spectrum
    Js, E_os = [], []
    for base in FLEET:
        Js.append(tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")),
                               1 / 75))
        with open(base + "_oracle.json") as f:
            E_os.append(json.load(f)["energy"])
    solvers = [tt.Solver(mode="Ising", Nx=8, Ny=8, Nc=8, J=Jb, beta=3,
                         device="cuda", dtype=torch.float32)
               for Jb in Js]
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = tt.multi_search_spectrum(
        solvers, [s._context() for s in solvers], 1, M=1024,
        relative_P_cutoff=1e-8, Dmax=32, max_dEng=1.0, cand_factor=8,
        stage_times=stages)
    for s, r in zip(solvers, rs):
        s.set_result(r)
        s.decode_low_energy_states(max_dEng=1.0)
    seconds = time.perf_counter() - t0
    print(f"spectrum fleet f32: {seconds:.3f} s for 8 "
          f"chimera-512 ({60 * 8 / seconds:.2f} instances/min)  stages "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items()),
          flush=True)
    for b, (s, Jb, E_o) in enumerate(zip(solvers, Js, E_os)):
        err = float(abs(tt.energy_Jij(Jb, s.binary_states())
                        - s.energy).max())
        print(f"  s{b + 1}: {len(s.energy)} states, lowest "
              f"{s.energy[0]:.6f} (GS oracle {E_o:.6f}), merge_overflow "
              f"{s.merge_overflow}, recheck error {err:.3g}", flush=True)
        check(err <= 1e-9, f"spectrum fleet s{b + 1}: decoded energies "
              f"differ from energy_Jij by {err}")
        check(s.energy[0] <= E_o + 1e-6, f"spectrum fleet s{b + 1}: "
              f"lowest {s.energy[0]} above the GS oracle {E_o}")
    return runs["f32"][3]


# ---------------------------------------------------------------------------
# phase 7: the Solver's own paths
# ---------------------------------------------------------------------------

def e05_model():
    """The 3x5 lattice of 3-state variables with Potts-like penalty
    factors of ``examples/e05_minimal_rmf.py`` (copied: the example
    imports tnax)."""
    import numpy as np
    Nx, Ny = 5, 3
    N = np.zeros((Ny, Nx), dtype=int) + 3
    fun = {1: np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]]),
           2: np.array([-1.5, 0, 1.5]),
           3: np.array([1.25, 0, -1.25])}
    fac = {}
    for ny in range(Ny):
        for nx in range(Nx - 1):
            fac[(ny, nx, ny, nx + 1)] = 1
    for ny in range(Ny - 1):
        for nx in range(Nx):
            fac[(ny, nx, ny + 1, nx)] = 1
    for nx in range(Nx):
        fac[(0, nx)] = 2
        fac[(1, nx)] = 3
        fac[(2, nx)] = 2
    return {"fun": fun, "fac": fac, "N": N, "Nx": Nx, "Ny": Ny}


def timed(torch, fn):
    """(seconds, launch counts, stage times) of ``fn(stages)``, the
    counts set to 0 just before and read just after."""
    from tnax_torch import kernels
    stages = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fn(stages)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, kernels.launch_counts(), stages


def fmt(stages):
    return " ".join(f"{k}={v:.3f}" for k, v in stages.items())


def gs_recheck(tt, J, ins, label):
    """Gate the Solver's energy on ``energy_Jij`` of its decoded state."""
    E = float(tt.energy_Jij(J, ins.binary_states(1))[0])
    err = abs(float(ins.energy[0]) - E)
    check(err <= 1e-9, f"{label}: energy {ins.energy[0]} differs from the "
          f"recheck {E} by {err}")
    return E


def solver_phase(tt, torch):
    """Phase 7: the Solver's own paths, through its methods only.
    (a) chimera-2048: precondition() then search_ground_state(path=
    "device"), f32; (b) the same gauges, path="host", f32;
    (c) chimera-512 s1 in f64, the host search against the device search
    at the full expansion and the GS oracle; (d) e02 sampling on s1, both
    paths, f32 and f64, the f64 means against tnax's sampling oracle; (e)
    the chimera-128 spectrum oracle's point in f64 on the host path,
    against the oracle and the device path; (f) the e05 RMF model, f64 and
    f32, both spectrum and search paths, with K2 and K3 against their
    plain versions at its widths; (g) save and load of (a)'s and (e)'s
    ee=2 results. Returns the launch counts of the f32 Solver runs on the
    device path and on the host path, and (a)'s preconditioned Solver."""
    import tempfile
    import numpy as np
    from tnax_torch import kernels, search
    t_phase = time.perf_counter()
    solver = {}
    solver_host = {}

    # (a) device search at full size
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)
    with open(ORACLE) as f:
        orc = json.load(f)
    gs_kw = dict(M=1024, relative_P_cutoff=1e-8, Dmax=32)
    ins = tt.Solver(mode="Ising", Nx=16, Ny=16, Nc=8, J=J, beta=3,
                    device="cuda", dtype=torch.float32)

    def run(stages):
        ins.precondition(stage_times=stages)
        ins.search_ground_state(path="device", stage_times=stages, **gs_kw)
    seconds, counts, stages = timed(torch, run)
    E = gs_recheck(tt, J, ins, "solver 2048 device f32")
    print(f"solver 2048 device f32: {seconds:.3f} s  stages "
          f"{fmt(stages)}  energy {ins.energy[0]:.6f} recheck {E:.6f} "
          f"(f64 oracle {orc['energy']})  deg {ins.degeneracy}  "
          f"merge_overflow {ins.merge_overflow}  launches {counts}",
          flush=True)
    for k in SEARCH_KERNELS:
        check(counts[k] > 0, f"solver 2048 device f32: kernel {k} was not "
              f"launched")
    check(counts["merge"] == counts["marginal_epilogue"] == 256,
          f"solver 2048 device f32: K2/K3 launches {counts}, want one per "
          f"site (256)")
    check(counts["polish"] == counts["zipup"] == 2 * 16, f"solver 2048 "
          f"device f32: K5 launches {counts['polish']}, K6 "
          f"{counts['zipup']}, want one each per ladder row (32)")
    solver.update({k: counts[k]
                   for k in SEARCH_KERNELS + ("polish", "zipup", "svd")})
    ins_a = ins

    # (b) host search at full size, on (a)'s gauges; the wait of each
    # site's read is timed by wrapping search.host_read
    waits = []
    host_read = search.host_read

    def timed_read(*ts):
        t0 = time.perf_counter()
        out = host_read(*ts)
        waits.append(time.perf_counter() - t0)
        return out
    search.host_read = timed_read
    try:
        seconds, counts, stages = timed(
            torch, lambda st: ins.search_ground_state(
                path="host", stage_times=st, **gs_kw))
    finally:
        search.host_read = host_read
    E = gs_recheck(tt, J, ins, "solver 2048 host f32")
    per_site = stages["search"] / 256
    print(f"solver 2048 host f32: {seconds:.3f} s  stages {fmt(stages)}  "
          f"energy {ins.energy[0]:.6f} recheck {E:.6f}, gap to the f64 "
          f"oracle {orc['energy']}: {E - orc['energy']:.6g}  deg "
          f"{ins.degeneracy} (oracle {orc['degeneracy']})  per site "
          f"{1e3 * per_site:.2f} ms, of it waiting for the read "
          f"{1e3 * sum(waits) / 256:.2f} ms ({len(waits)} reads), host "
          f"bookkeeping {1e3 * (per_site - sum(waits) / 256):.2f} ms  "
          f"launches {counts}", flush=True)
    check(counts["marginal_epilogue"] == 256 and counts["merge"] == 0,
          f"solver 2048 host f32: launches {counts}, want K3 once per site "
          f"(256) and no K2")
    solver_host.update({k: counts[k]
                        for k in SEARCH_KERNELS + ("polish", "zipup", "svd")})

    # (c) host search in float64 at full width against the device search
    # at the full expansion
    base = FLEET[0]
    J1 = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")), 1 / 75)
    with open(base + "_oracle.json") as f:
        orc1 = json.load(f)
    ins = tt.Solver(mode="Ising", Nx=8, Ny=8, Nc=8, J=J1, beta=3,
                    device="cuda", dtype=torch.float64)
    ins.precondition()
    res = {}
    for path, kw in (("host", {}), ("device", dict(cand_factor=None))):
        seconds, counts, stages = timed(
            torch, lambda st: ins.search_ground_state(
                path=path, stage_times=st, **gs_kw, **kw))
        E = gs_recheck(tt, J1, ins, f"solver 512 s1 {path} f64")
        res[path] = (E, ins.degeneracy)
        print(f"solver 512 s1 {path} f64: {seconds:.3f} s  stages "
              f"{fmt(stages)}  energy {E:.9f} deg {ins.degeneracy} (oracle "
              f"{orc1['energy']}, deg {orc1['degeneracy']})  launches "
              f"{counts}", flush=True)
        check(E <= orc1["energy"] + 1e-9, f"solver 512 s1 {path} f64: "
              f"energy {E} above the oracle {orc1['energy']}")
        check(counts["marginal_epilogue"] == 64, f"solver 512 s1 {path}: "
              f"K3 launches {counts['marginal_epilogue']}, want 64")
    check(abs(res["host"][0] - res["device"][0]) <= 1e-9
          and res["host"][1] == res["device"][1],
          f"solver 512 s1 f64: host {res['host']} != device {res['device']}")

    # (d) sampling as e02 runs it, at the sampling oracle's ladder
    with open(SAMPLE_ORACLE) as f:
        sorc = json.load(f)
    tol = 5 * sorc["std"] * (1 / E02_M + 1 / sorc["N"]) ** 0.5
    for dtype, dl in ((torch.float32, "f32"), (torch.float64, "f64")):
        ins = tt.Solver(mode="Ising", Nx=8, Ny=8, Nc=8, J=J1, beta=3,
                        device="cuda", dtype=dtype)
        # the oracle's ladder: two rungs at D=8, 20 sweeps, tolS 1e-15
        seconds, counts, stages = timed(
            torch, lambda st: ins.precondition(tolS=1e-15, stage_times=st))
        print(f"solver e02 s1 {dl} precondition: {seconds:.3f} s  launches "
              f"{counts}", flush=True)
        check(counts["gebal"] > 0, f"solver e02 {dl}: K1 was not launched")
        for path in ("host", "device"):
            seconds, counts, stages = timed(
                torch, lambda st: ins.gibbs_sampling(
                    M=E02_M, Dmax=SAMPLE_KW["Dmax"], seed=0, path=path,
                    stage_times=st))
            E = tt.energy_Jij(J1, ins.binary_states())
            err = float(abs(E - ins.energy).max())
            mean = float(np.mean(ins.energy))
            print(f"solver e02 s1 {dl} {path}: {seconds:.3f} s  stages "
                  f"{fmt(stages)}  mean {mean:.6f} (tnax oracle "
                  f"{sorc['mean']:.6f}, tolerance {tol:.6f})  recheck error "
                  f"{err:.3g}  negative_probability "
                  f"{ins.negative_probability:.3g}  launches {counts}",
                  flush=True)
            check(ins.energy.shape == (E02_M,) and err <= 1e-9,
                  f"solver e02 {dl} {path}: energies differ from their "
                  f"recheck by {err}")
            f32 = dtype == torch.float32
            check(counts == dict(gebal=0, merge=0, marginal_epilogue=0,
                                 sample_site=64, polish=0, zipup=0,
                                 svd=k7_calls(stages))
                  and (counts["svd"] > 0) == f32,
                  f"solver e02 {dl} {path}: launches {counts}, want K4 once "
                  f"per site, K7 once per float32 boundary SVD the stage "
                  f"clock counted")
            if dtype == torch.float64:
                check(abs(mean - sorc["mean"]) <= tol,
                      f"solver e02 f64 {path}: mean {mean} more than {tol} "
                      f"from the tnax oracle {sorc['mean']}")
            else:
                (solver if path == "device" else solver_host)[
                    "sample_site"] = counts["sample_site"]

    # (e) the host spectrum at the chimera-128 oracle's point
    with open(SPECTRUM_ORACLE) as f:
        sp = json.load(f)
    J128 = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(os.path.join(
        DATA, sp["instance"]))), 1 / 75)
    spectra = {}
    for run_o in sp["runs"]:
        ee = run_o["excitations_encoding"]
        for path in ("host", "device"):
            ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J128,
                            beta=sp["beta"], device="cuda",
                            dtype=torch.float64)
            if ee > 1:
                np.random.seed(7)
                ins.add_noise(1e-7)

            def run(stages):
                ins.search_low_energy_spectrum(
                    excitations_encoding=ee, M=sp["M"],
                    relative_P_cutoff=sp["relative_P_cutoff"],
                    Dmax=sp["Dmax"], max_dEng=sp["max_dEng"], path=path,
                    cand_factor=sp["initial_cand_factor"],
                    zipup_rsvd=sp["zipup_rsvd"], stage_times=stages)
                ins.decode_low_energy_states(max_dEng=sp["max_dEng"])
            seconds, counts, stages = timed(torch, run)
            err = float(abs(tt.energy_Jij(noisy_couplings(ins),
                                          ins.binary_states())
                            - ins.energy).max())
            print(f"solver spectrum 128 f64 ee={ee} {path}: {seconds:.3f} s "
                  f" stages {fmt(stages)}  {len(ins.energy)} states (oracle "
                  f"{len(run_o['energies'])}), degeneracy {ins.degeneracy} "
                  f"(oracle {run_o['degeneracy']}), recheck error {err:.3g}"
                  f"  launches {counts}", flush=True)
            check(err <= 1e-9, f"solver spectrum ee={ee} {path}: decoded "
                  f"energies differ from energy_Jij by {err}")
            check(counts["marginal_epilogue"] > 0, f"solver spectrum ee={ee}"
                  f" {path}: K3 was not launched")
            spectra[path] = ins
        got = sorted_pairs(spectra["host"].energy, spectra["host"].states)
        for name, want in (("the oracle", sorted_pairs(run_o["energies"],
                                                       run_o["states"])),
                           ("the device path",
                            sorted_pairs(spectra["device"].energy,
                                         spectra["device"].states))):
            same = len(got[0]) == len(want[0]) and bool(
                np.abs(got[0] - want[0]).max() <= 1e-9) \
                and np.array_equal(got[1], want[1])
            check(same, f"solver spectrum ee={ee}: the host path's "
                  f"{len(got[0])} states are not those of {name} "
                  f"({len(want[0])})")
        print(f"  solver spectrum 128 ee={ee}: the host path decodes the "
              f"oracle's and the device path's sets of states", flush=True)
    ins_e = spectra["host"]

    # (f) RMF: e05's model, both spectrum paths and both search paths
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.float64):
        # K3 and K2 at its widths against their plain versions
        Np = lh = lv = 3
        lB = torch.as_tensor(-np.abs(rng.standard_normal((1, Np, lh, lv)))
                             * 8).to("cuda", dtype)
        T2 = torch.as_tensor(np.abs(rng.standard_normal((1, 1024, lh * lv)))
                             ).to("cuda", dtype)
        args = (T2, kernels.marginal.boltzmann_columns(lB),
                torch.tensor([[0, 4, 8]], device="cuda"),
                torch.as_tensor(rng.integers(0, 3, (1, 1024))).cuda(),
                torch.as_tensor(rng.integers(0, 3, (1, 1024))).cuda(),
                torch.tensor([3], device="cuda"),
                torch.as_tensor(-np.abs(rng.standard_normal((1, 1024)))
                                ).to("cuda", dtype),
                torch.ones((1, 1024), dtype=torch.bool, device="cuda"),
                float(np.log2(1e-12)))
        k3 = list(zip(kernels.marginal_epilogue(*args),
                      kernels.marginal_epilogue_plain(*args)))
        err = max(max_abs_err(a, b, torch) for a, b in k3)
        kb = (1024 - 1).bit_length() + 2 * 2 + 1
        keyed = (torch.as_tensor(rng.integers(0, 2 ** kb, (1, 3072))
                                 .astype(np.int32)).cuda(),
                 torch.as_tensor(rng.integers(-300, 300, (1, 3072)) / 4.0
                                 ).cuda(),
                 torch.as_tensor(-np.abs(rng.standard_normal((1, 3072)))
                                 ).to("cuda", dtype),
                 torch.ones((1, 3072), dtype=torch.bool, device="cuda"),
                 torch.ones((1, 3072), dtype=torch.int64, device="cuda"))
        got = kernels.merge_segments(*keyed, 1e-12, key_bits=kb)
        want = kernels.merge_segments_plain(*keyed, 1e-12)
        exact = all(torch.equal(got[i], want[i]) for i in (0, 1, 2, 3, 5))
        err2 = max_abs_err(got[4], want[4], torch)
        rt = RTOL[str(dtype).split(".")[1]]
        close = all(torch.allclose(a, b, rtol=rt, atol=rt) for a, b in k3) \
            and torch.allclose(got[4], want[4], rtol=rt, atol=rt)
        print(f"solver rmf kernels {dtype}: K3 max_abs_err {err:.3g}, K2 "
              f"exact {exact}, gprob max_abs_err {err2:.3g} (rtol = atol = "
              f"{rt})", flush=True)
        check(close and exact, f"solver rmf kernels {dtype}: K3 {err}, K2 "
              f"exact {exact} {err2}")
        gs = {}
        for path in ("host", "device"):
            ins = tt.Solver(mode="RMF", Nx=5, Ny=3, J=e05_model(), beta=4,
                            device="cuda", dtype=dtype)

            def run(stages):
                ins.search_low_energy_spectrum(
                    excitations_encoding=1, M=1024, relative_P_cutoff=1e-12,
                    Dmax=32, max_dEng=3.1, path=path, stage_times=stages)
                ins.decode_low_energy_states(max_dEng=3.1, max_states=100)
            seconds, counts, stages = timed(torch, run)
            err = float(abs(tt.energy_RMF(e05_model(), ins.binary_states())
                            - ins.energy).max())
            n = int((ins.energy <= ins.energy[0] + 3.1).sum())
            ins.search_ground_state(M=1024, relative_P_cutoff=1e-12,
                                    Dmax=32, path=path)
            gs[path] = float(ins.energy[0])
            print(f"solver rmf e05 {dtype} {path}: {seconds:.3f} s  {n} "
                  f"states within dE=3.1, recheck error {err:.3g}, GS "
                  f"{gs[path]:.9f}  launches {counts}", flush=True)
            check(n == 26 and err <= 1e-9, f"solver rmf e05 {dtype} {path}:"
                  f" {n} states (want 26), recheck error {err}")
            check(counts["marginal_epilogue"] > 0
                  and (counts["merge"] > 0) == (path == "device"),
                  f"solver rmf e05 {path}: launches {counts}")
        check(abs(gs["host"] - gs["device"]) <= 1e-9,
              f"solver rmf e05 {dtype}: GS {gs}")

    # (g) save and load
    with tempfile.TemporaryDirectory() as d:
        for name, src, dE in (("gs 2048", ins_a, None),
                              ("spectrum 128 ee=2", ins_e, 1.0)):
            path = os.path.join(d, "result.npy")
            src.save(path)
            out = tt.load(path)
            if dE is not None:
                out.decode_low_energy_states(max_dEng=dE)
            same = np.array_equal(out.binary_states(), src.binary_states()) \
                and bool(np.abs(out.energy - src.energy).max() <= 1e-12)
            print(f"solver save/load {name}: {len(out.energy)} states, the "
                  f"same decoded states: {same}", flush=True)
            check(same, f"solver save/load {name}: the loaded solver decodes "
                  f"other states")
    print(f"phase 7 (the Solver's own paths): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return solver, solver_host, ins_a


def rel_close(a, b, rtol):
    """Norm-wise relative agreement of two tensors (any devices):
    max |a - b| <= rtol * max |b|; returns (ok, that ratio)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    scale = float(b.abs().max()) if b.numel() else 0.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    ratio = err / scale if scale > 0 else err
    return ratio <= rtol, ratio


def log2z_interfaces(tt, first, ln_first, second, ln_second):
    """log2 of the contraction at every interface k of two boundary
    stacks (B = 1) that meet there: log2 |<first[k]|second[k]>| plus both
    lognorms."""
    z = tt.bmps.mps_dot(first[0], second[0])
    return z.abs().log2() + ln_first[0] + ln_second[0]


def host_pre_phase(tt, torch):
    """Phase 8: the host preconditioner and the MPS API.
    (a) chimera-2048 f32: precondition(path="host") (two rungs of 'ud'
    sweeps on the host) then the device search, gated on the oracle;
    (b) the same instance, 'ud' then 'lr' on the host: the gauge
    invariants exactly, then the host and the device searches, each
    energy against its recheck; (c) chimera-512 s1 f64: the host 'ud'
    against the device ladder (K1) at tnax's tolerances, then 'ud' + 'lr'
    and the host search against the GS oracle; (d) build_rhoB/L/R (and T)
    at chimera-128 f64 D=8, the fat build_rhoT there at D=16,
    on the card against the CPU through log2 Z at every row and column
    interface; (e) the MPS API on a chimera-2048 row (L=16, D=32, d=16),
    float64 and complex128, the card against the CPU. Returns the launch
    counts of the Solver runs, summed apart: those of the chimera-2048
    host path ((a) and (b)) and those of chimera-512 ((c): the device
    ladder it is held against, the only K1, and the host run)."""
    import numpy as np
    t_phase = time.perf_counter()
    total = {2048: {}, 512: {}}

    def add(counts, size):
        for k, v in counts.items():
            total[size][k] = total[size].get(k, 0) + v

    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)
    with open(ORACLE) as f:
        orc = json.load(f)
    gs_kw = dict(M=1024, relative_P_cutoff=1e-8, Dmax=32)

    def solver2048():
        return tt.Solver(mode="Ising", Nx=16, Ny=16, Nc=8, J=J, beta=3,
                         device="cuda", dtype=torch.float32)

    # (a) host 'ud' at chimera-2048, then the device search
    ins = solver2048()

    def run_a(stages):
        ins.precondition(path="host", stage_times=stages)
        ins.search_ground_state(path="device", stage_times=stages, **gs_kw)
    seconds, counts, stages = timed(torch, run_a)
    add(counts, 2048)
    E = gs_recheck(tt, J, ins, "host pre 2048 ud device")
    print(f"host pre 2048 ud + device search f32: {seconds:.3f} s  stages "
          f"{fmt(stages)}  energy {E:.6f} (f64 oracle {orc['energy']})  deg "
          f"{ins.degeneracy} (oracle {orc['degeneracy']})  launches "
          f"{counts}", flush=True)
    check(abs(E - orc["energy"]) <= 1e-6
          and ins.degeneracy == orc["degeneracy"],
          f"host pre 2048 ud: energy {E} deg {ins.degeneracy}, want the "
          f"oracle's {orc['energy']} deg {orc['degeneracy']}")
    rows = stages.get("ud builds#rows", 0)
    check(counts == dict(gebal=0, merge=256, marginal_epilogue=256,
                         sample_site=0, polish=2 * 16, zipup=2 * 16,
                         svd=k7_calls(stages))
          and counts["zipup"] == rows and counts["svd"] > 0,
          f"host pre 2048 ud: launches {counts}, rows built {rows}, want no "
          f"K1 (host sweeps), K2/K3 once per site, K6 and K5 once per "
          f"row of the two rungs' float32 D=8 stacks and K7 once per SVD "
          f"of the float32 boundary ({k7_calls(stages)} counted)")

    # (b) 'ud' then 'lr' on the host, then both searches
    ins = solver2048()
    seconds, counts, stages = timed(torch, lambda st: ins.precondition(
        path="host", directions=("ud", "lr"), stage_times=st))
    add(counts, 2048)
    X = ins._gauges
    inv_ud = bool((X["Xd"][:, :-1] * X["Xu"][:, 1:] == 1).all())
    inv_lr = bool((X["Xr"][:, :, :-1] * X["Xl"][:, :, 1:] == 1).all())
    print(f"host pre 2048 ud+lr f32: {seconds:.3f} s  stages {fmt(stages)}"
          f"  invariants Xd*Xu == 1: {inv_ud}, Xr*Xl == 1: {inv_lr}  "
          f"launches {counts}", flush=True)
    check(inv_ud and inv_lr and counts["gebal"] == 0,
          f"host pre 2048 ud+lr: invariants {inv_ud} {inv_lr}, launches "
          f"{counts}")
    for path in ("host", "device"):
        seconds, counts, stages = timed(torch, lambda st: (
            ins.search_ground_state(path=path, stage_times=st, **gs_kw)))
        add(counts, 2048)
        E = gs_recheck(tt, J, ins, f"host pre 2048 ud+lr {path} search")
        at = abs(E - orc["energy"]) <= 1e-6 \
            and ins.degeneracy == orc["degeneracy"]
        print(f"host pre 2048 ud+lr, {path} search f32: {seconds:.3f} s  "
              f"stages {fmt(stages)}  energy {E:.6f} deg {ins.degeneracy}: "
              f"reaches the oracle ({orc['energy']}, deg "
              f"{orc['degeneracy']}): {at}  launches {counts}", flush=True)
        check(counts["marginal_epilogue"] == 256
              and counts["merge"] == (256 if path == "device" else 0),
              f"host pre 2048 ud+lr {path}: launches {counts}")

    # (c) chimera-512 s1 in f64: host 'ud' against the device ladder
    base = FLEET[0]
    J1 = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(base + ".txt")), 1 / 75)
    with open(base + "_oracle.json") as f:
        orc1 = json.load(f)

    def solver512():
        return tt.Solver(mode="Ising", Nx=8, Ny=8, Nc=8, J=J1, beta=3,
                         device="cuda", dtype=torch.float64)
    pair = {}
    for path in ("host", "device"):
        s = solver512()
        seconds, counts, stages = timed(torch, lambda st: s.precondition(
            path=path, stage_times=st))
        add(counts, 512)
        pair[path] = s
        print(f"host pre 512 s1 f64 {path} ud: {seconds:.3f} s  stages "
              f"{fmt(stages)}  launches {counts}", flush=True)
        check(counts["gebal"] == (2 * 2 * 8 if path == "device" else 0),
              f"host pre 512 {path}: K1 launches {counts['gebal']}")
    h, d = pair["host"], pair["device"]
    gerr = max(float(((h._gauges[k] - d._gauges[k]).abs()
                      / d._gauges[k].abs()).max()) for k in h._gauges)
    oerr = float(np.max(np.abs(h.overlaps_ud - d.overlaps_ud)
                        - 1e-6 * np.abs(d.overlaps_ud)))
    print(f"host pre 512 s1 f64: host 'ud' against the device ladder: "
          f"gauges max relative difference {gerr:.3g} (rtol 1e-9), "
          f"overlaps_ud max |diff| - 1e-6 |device| {oerr:.3g} (atol 1e-9)",
          flush=True)
    check(gerr <= 1e-9 and oerr <= 1e-9,
          f"host pre 512: host and device 'ud' differ: gauges {gerr}, "
          f"overlaps {oerr}")
    ins_c = solver512()

    def run_c(stages):
        ins_c.precondition(path="host", directions=("ud", "lr"),
                           stage_times=stages)
        ins_c.search_ground_state(path="host", stage_times=stages, **gs_kw)
    seconds, counts, stages = timed(torch, run_c)
    add(counts, 512)
    E = gs_recheck(tt, J1, ins_c, "host pre 512 ud+lr host search")
    print(f"host pre 512 s1 f64 ud+lr + host search: {seconds:.3f} s  "
          f"stages {fmt(stages)}  energy {E:.9f} deg {ins_c.degeneracy} "
          f"(oracle {orc1['energy']}, deg {orc1['degeneracy']})  launches "
          f"{counts}", flush=True)
    check(abs(E - orc1["energy"]) <= 1e-9
          and ins_c.degeneracy == orc1["degeneracy"],
          f"host pre 512 ud+lr: energy {E} deg {ins_c.degeneracy}, want the "
          f"oracle's {orc1['energy']} deg {orc1['degeneracy']}")
    check(counts["marginal_epilogue"] == 64 and counts["gebal"] == 0,
          f"host pre 512 ud+lr: launches {counts}")

    # (d) the boundary stacks on the card against the CPU, at chimera-128
    # (the CPU's builds at chimera-512 took most of the phase's clock)
    t0 = time.perf_counter()
    J128 = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(os.path.join(
        DATA, "chimera128_synth_s0.txt"))), 1 / 75)
    s128 = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J128, beta=3,
                     device="cuda", dtype=torch.float64)
    Wt = s128._context().Wt
    kw = dict(Dmax=8, tolS=1e-16, tolV=1e-10, max_sweeps=20)
    log2z = {}
    for dev in ("cuda", "cpu"):
        W = Wt.to(dev)
        T, B, L, R = (getattr(tt.engine, f"build_rho{x}")(W, **kw)
                      for x in "TBLR")
        log2z[dev] = (log2z_interfaces(tt, T[0], T[1], B[0], B[1]),
                      log2z_interfaces(tt, R[0], R[1], L[0], L[1]))
    for i, name in enumerate(("rows (rhoT.rhoB)", "columns (rhoR.rhoL)")):
        ok, ratio = rel_close(log2z["cuda"][i], log2z["cpu"][i], 1e-9)
        z = log2z["cuda"][i].cpu()
        print(f"host pre stacks 128 f64 D=8 {name}: log2 Z at "
              f"{z.numel()} interfaces, spread {float(z.max() - z.min()):.6g}"
              f" around {float(z.mean()):.9f}; card against CPU relative "
              f"{ratio:.3g}", flush=True)
        check(ok, f"stacks 128 {name}: the card's log2 Z differ from the "
              f"CPU's by {ratio} relative")
    kw = dict(Dmax=16, tolS=1e-16, tolV=1e-10, max_sweeps=20)
    fat = {}
    for dev in ("cuda", "cpu"):
        W = Wt.to(dev)
        B = tt.engine.build_rhoB(W, **kw)
        Tf = tt.engine.build_rhoT(W, method="fat", **kw)
        Tz = tt.engine.build_rhoT(W, **kw)
        fat[dev] = (log2z_interfaces(tt, Tf[0], Tf[1], B[0], B[1]),
                    log2z_interfaces(tt, Tz[0], Tz[1], B[0], B[1]))
    ok, ratio = rel_close(fat["cuda"][0], fat["cpu"][0], 1e-9)
    zf, zz = fat["cuda"][0].cpu(), fat["cuda"][1].cpu()
    print(f"host pre stacks 128 f64 D=16 fat rhoT: log2 Z spread "
          f"{float(zf.max() - zf.min()):.6g} around {float(zf.mean()):.9f};"
          f" card against CPU relative {ratio:.3g}; zip-up against fat max "
          f"|log2 Z difference| {float((zf - zz).abs().max()):.3g}  "
          f"({time.perf_counter() - t0:.1f} s for (d))", flush=True)
    check(ok, f"fat rhoT 128: the card's log2 Z differ from the CPU's by "
          f"{ratio} relative")

    # (e) the MPS API on a chimera-2048 row, card against CPU
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(3)
    W = torch.randn((16, 16, 16, 16, 16), generator=gen,
                    dtype=torch.float64)
    Wns = torch.randn((3, 16, 16, 16, 16), generator=gen,
                      dtype=torch.float64)
    O1 = torch.randn((16, 16), generator=gen, dtype=torch.float64)
    O2 = torch.randn((16, 16, 16, 16), generator=gen, dtype=torch.float64)
    worst = {}
    for initial in ("randR", "randC"):
        out = {}
        for dev in ("cuda", "cpu"):
            bm = tt.bmps
            r = {}
            for canon in ("left", "right", "none"):
                m = bm.init_mps(16, 32, 16, torch.float64, initial=initial,
                                canonize=canon, seed=1, device=dev)
                A = m.A
                r[f"{canon} lognorm"] = m.lognorm
                r[f"{canon} norm"] = bm.mps_dot(A.conj(), A)
                r[f"{canon} O1"] = bm.measure_O1(A, O1)
                if canon != "right":
                    # a raw site's ranks are its draws' and a
                    # left-canonical one's its Dr orthonormal columns; a
                    # right-canonical one's as (Dl d, Dr) count the QR's
                    # free completion rows
                    r[f"{canon} describe"] = bm.describe(m)
            m, _ = bm.canonize_left(bm.init_mps(
                16, 32, 16, torch.float64, initial=initial, canonize="none",
                seed=2, device=dev))
            A = m.A
            Wd = W.to(dev, A.dtype)
            r["O2"] = bm.measure_O2(A, O2)
            r["correlations"] = bm.measure_correlations(A, O1)
            r["mps_dot"] = bm.mps_dot(A, A)
            r["expectation_mpo"] = bm.expectation_mpo(A, Wd, A)
            r["identity_mpo"] = bm.expectation_mpo(A, bm.identity_mpo(
                16, 16, 16, A.dtype, device=dev), A)
            r["mix"] = bm.expectation_1mpo_mix(A, Wd, A, 7,
                                               Wns[0].to(dev, A.dtype))
            r["list_mix"] = bm.expectation_list_1mpo_mix(
                A, Wd, A, 15, Wns.to(dev, A.dtype))
            FL, FR = bm.mpo_envs_at(A, Wd, A, 5)
            r["envs_at"] = torch.einsum("blk,kdm,lerd,bec,crm->", FL, A[5],
                                        bm.mpo_from_block(
                                            Wd[5].reshape(256, 256), 16, 16),
                                        A[5], FR)
            out[dev] = r
        for k, v in out["cuda"].items():
            if isinstance(v, str):
                ok, ratio = v == out["cpu"][k], 0.0
            else:
                ok, ratio = rel_close(v.reshape(-1), out["cpu"][k]
                                      .reshape(-1), 1e-9)
            worst[(initial, k)] = ratio
            check(ok, f"MPS API {initial} {k}: the card differs from the CPU"
                  f" ({ratio} relative)")
        print(f"host pre MPS API {initial} (L=16, D=32, d=16): "
              f"{len(out['cuda'])} results, card against CPU worst relative "
              f"{max(v for (i, _), v in worst.items() if i == initial):.3g}",
              flush=True)
    print(f"  (e) {time.perf_counter() - t0:.1f} s", flush=True)
    for k in SEARCH_KERNELS:
        check(total[2048][k] + total[512][k] > 0,
              f"phase 8: kernel {k} was not launched")
    print(f"phase 8 (the host preconditioner and the MPS API): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_rank(rank, port, out):
    """One of phase 9's two gloo ranks, both on cuda:0 (see mesh_phase);
    saves what the parent gates to out/rank<r>.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import tnax_torch as tt
    from tnax_torch import parallel, spectrum
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    res = {}

    def solver512(s, dtype):
        J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(FLEET[s] + ".txt")), 1 / 75)
        return J, tt.Solver(mode="Ising", Nx=8, Ny=8, Nc=8, J=J, beta=3,
                            device="cuda", dtype=dtype)

    # (b1) (1, 2): the beam-sharded search on chimera-512 s1, float64
    mesh = parallel.make_mesh(1, 2, devices=[dev, dev])
    J1, ins = solver512(0, torch.float64)
    ins.precondition()
    ctx = ins._context()
    kw = dict(M=1024, relative_P_cutoff=1e-8, Dmax=32, cand_factor=2)
    out1 = []
    seconds, counts, stages = timed(torch, lambda st: out1.append(
        parallel.sharded_search_gs([ctx], mesh, stage_times=st, **kw)[0]))
    r = out1[0]
    ins.states = np.asarray(r["states"])[None, :][:, ins.order]
    res["b1"] = dict(r, seconds=seconds, counts=counts, stages=stages,
                     recheck=float(tt.energy_Jij(J1, ins.binary_states())[0]))
    if rank == 0:
        res["b1_single"] = parallel.device_search_gs(ctx, **kw)

    # (b2) (2, 1): the data-parallel fleet search of s1-s8, float64
    mesh = parallel.make_mesh(2, 1, devices=[dev, dev])
    ctxs = [solver512(s, torch.float64)[1]._context() for s in range(8)]
    kw = dict(M=256, relative_P_cutoff=1e-8, Dmax=16, cand_factor=2)
    t0 = time.perf_counter()
    res["b2"] = parallel.multi_search_gs(ctxs, mesh=mesh, **kw)
    res["b2_seconds"] = time.perf_counter() - t0
    if rank == 0:
        res["b2_ref"] = parallel.multi_search_gs(ctxs, **kw)

    # (b3) the data-parallel fleet sampler on s1-s4, float64
    solvers = [solver512(s, torch.float64)[1] for s in range(4)]
    kw = dict(M=128, Dmax=16, seed=FLEET_SEED)
    t0 = time.perf_counter()
    res["b3"] = tt.multi_flagship_sample(solvers, mesh=mesh, **kw)
    res["b3_seconds"] = time.perf_counter() - t0
    if rank == 0:
        res["b3_ref"] = tt.multi_flagship_sample(solvers, **kw)

    # (b4) (1, 2): the beam-sharded spectrum at the chimera-128 oracle's
    # point, float64
    mesh = parallel.make_mesh(1, 2, devices=[dev, dev])
    with open(SPECTRUM_ORACLE) as f:
        orc = json.load(f)
    run = orc["runs"][0]
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(os.path.join(
        DATA, orc["instance"]))), 1 / 75)
    ins = tt.Solver(mode="Ising", Nx=4, Ny=4, Nc=8, J=J, beta=orc["beta"],
                    device="cuda", dtype=torch.float64)
    out4 = []
    seconds, counts, stages = timed(torch, lambda st: out4.append(
        spectrum.sharded_search_spectrum(
            ins, ins._context(), 1, mesh, M=orc["M"],
            relative_P_cutoff=orc["relative_P_cutoff"],
            max_dEng=orc["max_dEng"], Dmax=orc["Dmax"],
            cand_factor=run["cand_factor"], zipup_rsvd=orc["zipup_rsvd"],
            stage_times=st)))
    ins.set_result(out4[0])
    ins.decode_low_energy_states(max_dEng=orc["max_dEng"])
    res["b4"] = dict(energy=ins.energy, states=ins.states,
                     overflow=out4[0].merge_overflow, seconds=seconds,
                     counts=counts, stages=stages,
                     recheck=tt.energy_Jij(J, ins.binary_states()))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def mesh_phase(tt, torch, ins_a):
    """Phase 9: the device mesh ('data' over instances, 'beam' over a
    search's branches) on torch.distributed.
    (a) NCCL, a (1, 1) mesh in this process: sharded_search_gs at
    chimera-2048 f32 (M=1024, D=32, cutoff 1e-8, cand_factor 8) on phase
    7's preconditioned Solver ``ins_a``, gated on the oracle (energy and
    degeneracy) and on the states of multi_search_gs on the same context;
    (b) two spawned gloo ranks, both on cuda:0 (NCCL takes one rank per
    card; gloo's collectives go through host memory): (b1) a (1, 2)
    sharded_search_gs on chimera-512 s1 f64 against its oracle; (b2) a
    (2, 1) multi_search_gs(mesh=) of the fleet of 8 (f64, M=256, D=16)
    against no mesh; (b3) multi_flagship_sample(mesh=) of s1-s4 (f64,
    M=128, D=16) bit for bit against no mesh; (b4) a (1, 2)
    sharded_search_spectrum at the chimera-128 spectrum oracle's point
    against the oracle. Returns the launch counts of (a)."""
    import tempfile
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from tnax_torch import parallel
    t_phase = time.perf_counter()
    with open(ORACLE) as f:
        orc = json.load(f)
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)

    # (a) NCCL (1, 1) in this process
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1, 1)
        ctx = ins_a._context()
        kw = dict(M=1024, relative_P_cutoff=1e-8, Dmax=32, cand_factor=8)
        got = []
        seconds, counts, stages = timed(torch, lambda st: got.append(
            parallel.sharded_search_gs([ctx], mesh, stage_times=st,
                                       **kw)[0]))
        want = parallel.multi_search_gs([ctx], **kw)[0]
    finally:
        dist.destroy_process_group()
    r = got[0]
    ins_a.states = np.asarray(r["states"])[None, :][:, ins_a.order]
    E = float(tt.energy_Jij(J, ins_a.binary_states())[0])
    print(f"mesh (a) NCCL (1, 1) sharded_search_gs chimera-2048 f32: "
          f"{seconds:.3f} s  stages {fmt(stages)}  energy {r['energy']:.6f} "
          f"recheck {E:.6f} deg {r['degeneracy']} (oracle {orc['energy']}, "
          f"deg {orc['degeneracy']})  merge_overflow {r['merge_overflow']}  "
          f"the states of multi_search_gs: "
          f"{np.array_equal(r['states'], want['states'])}  launches "
          f"{counts}", flush=True)
    check(abs(E - orc["energy"]) <= 1e-6 and r["degeneracy"]
          == orc["degeneracy"], f"mesh (a): energy {E} deg "
          f"{r['degeneracy']}, the oracle's {orc['energy']} deg "
          f"{orc['degeneracy']}")
    check(np.array_equal(r["states"], want["states"])
          and r["degeneracy"] == want["degeneracy"],
          "mesh (a): the sharded search and multi_search_gs differ")
    check(counts["merge"] == counts["marginal_epilogue"] == 256,
          f"mesh (a): K2/K3 launches {counts}, want one per site (256)")

    # (b) two gloo ranks on cuda:0
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ctx = mp.start_processes(mesh_rank, args=(free_port(), out),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > 600:
                    for p in ctx.processes:
                        p.kill()
                    fail("mesh (b): the gloo ranks ran past 600 s")
        except mp.ProcessRaisedException as e:
            fail(f"mesh (b): a gloo rank raised:\n{e}")
        except mp.ProcessExitedException as e:
            fail(f"mesh (b): a gloo rank exited: {e}")
        ranks = [torch.load(os.path.join(out, f"rank{k}.pt"),
                            weights_only=False) for k in range(2)]
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    with open(FLEET[0] + "_oracle.json") as f:
        orc1 = json.load(f)
    for k, rk in enumerate(ranks):
        b1 = rk["b1"]
        print(f"mesh (b1) gloo (1, 2) rank {k} sharded_search_gs chimera-512 "
              f"s1 f64: {b1['seconds']:.3f} s  stages {fmt(b1['stages'])}  "
              f"recheck {b1['recheck']:.9f} deg {b1['degeneracy']} (oracle "
              f"{orc1['energy']}, deg {orc1['degeneracy']})  launches "
              f"{b1['counts']}", flush=True)
        check(abs(b1["recheck"] - b1["energy"]) <= 1e-9
              and b1["recheck"] <= orc1["energy"] + 1e-9,
              f"mesh (b1) rank {k}: energy {b1['energy']} recheck "
              f"{b1['recheck']}, oracle {orc1['energy']}")
        check(np.array_equal(b1["states"], r0["b1"]["states"]),
              "mesh (b1): the ranks return other states")
        check(b1["counts"]["merge"] == b1["counts"]["marginal_epilogue"]
              == 64, f"mesh (b1) rank {k}: K2/K3 launches {b1['counts']}, "
              f"want one per site (64)")
    s1 = r0["b1_single"]
    print(f"  (b1) unsharded device_search_gs on rank 0's context: energy "
          f"{s1['energy']:.9f} deg {s1['degeneracy']}, the same state: "
          f"{np.array_equal(s1['states'], r0['b1']['states'])}", flush=True)
    same = all(np.array_equal(a["states"], b["states"])
               and a["degeneracy"] == b["degeneracy"]
               and abs(a["energy"] - b["energy"]) <= 1e-9
               for rk in ranks for a, b in zip(rk["b2"], r0["b2_ref"]))
    print(f"mesh (b2) gloo (2, 1) multi_search_gs(mesh=) fleet of 8 f64: "
          f"{r0['b2_seconds']:.3f} s, equal to no mesh: {same}", flush=True)
    check(same and len(r0["b2"]) == 8,
          "mesh (b2): the data mesh's results differ from no mesh")
    same = all(np.array_equal(a["states"], b["states"])
               and np.array_equal(a["energy"], b["energy"])
               for rk in ranks for a, b in zip(rk["b3"], r0["b3_ref"]))
    print(f"mesh (b3) gloo (2, 1) multi_flagship_sample(mesh=) s1-s4 f64: "
          f"{r0['b3_seconds']:.3f} s, bit for bit the states of no mesh: "
          f"{same}", flush=True)
    check(same and len(r0["b3"]) == 4,
          "mesh (b3): the data mesh's samples differ from no mesh")
    with open(SPECTRUM_ORACLE) as f:
        run = json.load(f)["runs"][0]
    for k, rk in enumerate(ranks):
        b4 = rk["b4"]
        E_o = np.asarray(run["energies"])
        ok = len(b4["energy"]) == len(E_o) and bool(
            np.abs(np.sort(b4["energy"]) - np.sort(E_o)).max() <= 1e-9)
        set_same = ok and all(np.array_equal(a, b) for a, b in zip(
            sorted_pairs(b4["energy"], b4["states"]),
            sorted_pairs(E_o, run["states"])))
        err = float(abs(b4["recheck"] - b4["energy"]).max())
        print(f"mesh (b4) gloo (1, 2) rank {k} sharded_search_spectrum "
              f"chimera-128 f64: {b4['seconds']:.3f} s  stages "
              f"{fmt(b4['stages'])}  {len(b4['energy'])} states (oracle "
              f"{len(E_o)}), merge_overflow {b4['overflow']}, recheck error "
              f"{err:.3g}, the oracle's set of states: {set_same}  launches "
              f"{b4['counts']}", flush=True)
        check(ok and err <= 1e-9 and b4["overflow"] == 0,
              f"mesh (b4) rank {k}: the decoded spectrum differs from the "
              f"tnax oracle's")
        check(b4["counts"]["merge"] == b4["counts"]["marginal_epilogue"]
              == 16, f"mesh (b4) rank {k}: K2/K3 launches {b4['counts']}, "
              f"want one per site (16)")
    print(f"phase 9 (the device mesh): {time.perf_counter() - t_phase:.1f} s "
          f"(the gloo ranks {spawn_s:.1f} s)", flush=True)
    return counts


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
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    names = ("gebal", "merge", "marginal", "sample", "polish", "zipup",
             "svd")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(build.load, names))
    for name in names:
        print(f"built {name}: {build.build_logs.get(name, '').strip()}",
              flush=True)
    print(f"nvcc builds: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    floor = launch_floor_ms(torch, dev)
    print(f"launch floor (one-element kernel): {floor:.4f} ms", flush=True)
    kres = kernel_checks(tt, torch, dev, floor)
    kres.update(polish_checks(tt, torch, floor))
    kres.update(zipup_checks(tt, torch, floor))
    kres.update(svd_checks(tt, torch, floor))

    # phase 3: the slice through its entry points
    J = tt.round_Jij(tt.Jij_f2p(tt.load_Jij(INSTANCE)), 1 / 75)
    with open(ORACLE) as f:
        oracle = json.load(f)
    runs = {}
    for dtype, labels in ((torch.float64, ["f64"]),
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
    full_phase(tt, torch, J)

    # phase 4: the fleet through its entry points
    fleet = fleet_phase(tt, torch)

    # phase 5: Gibbs sampling through its entry points
    sample = sample_phase(tt, torch)

    # phase 6: the low-energy spectrum through its entry points
    spectrum = spectrum_phase(tt, torch)

    # phase 7: the Solver's own paths
    solver, solver_host, ins_a = solver_phase(tt, torch)

    # phase 8: the host preconditioner and the MPS API
    host_pre = host_pre_phase(tt, torch)

    # phase 9: the device mesh
    mesh = mesh_phase(tt, torch, ins_a)

    # summary: kernel numbers in float32 at the fleet's shapes; launches
    # of the last f32 fleet batch of the path that runs the kernel (the
    # search for K1-K3, the sampler for K4), and of the last f32 single
    # search and f32 e02 fleet pass
    src = {"gebal": ("cuda", "tnax_torch/kernels/csrc/gebal.cu",
                     "tnax/precondition.py:280"),
           "merge": ("cuda", "tnax_torch/kernels/csrc/merge.cu",
                     "tnax/parallel.py:149"),
           "marginal_epilogue": ("cuda", "tnax_torch/kernels/csrc/marginal.cu",
                                 "tnax/engine.py:382"),
           "sample_site": ("cuda", "tnax_torch/kernels/csrc/sample.cu",
                           "tnax/parallel.py:1290"),
           "polish": ("cuda", "tnax_torch/kernels/csrc/polish.cu",
                      "tnax/bmps.py:702"),
           "zipup": ("cuda", "tnax_torch/kernels/csrc/zipup.cu",
                     "tnax/bmps.py:833"),
           "svd": ("cuda", "tnax_torch/kernels/csrc/svd.cu",
                   "none (tnax/bmps.py:217, jnp.linalg.svd by XLA)")}
    summary = []
    for name, (route, source, replaces) in src.items():
        r = kres[name]["float32"]["B8"]
        summary.append(dict(name=name, route=route, source=source,
                            replaces=replaces,
                            launches=(sample if name == "sample_site"
                                      else fleet)[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r.get("library_ms"),
                            device_ms=r["device_ms"], launch_floor_ms=floor,
                            **({"sort_ms": r["sort_ms"]} if "sort_ms" in r
                               else {}),
                            launches_single=single[name],
                            launches_sample_fleet=sample[name],
                            launches_spectrum=spectrum[name],
                            launches_solver=solver[name],
                            launches_solver_host=solver_host[name],
                            launches_host_pre_2048=host_pre[2048][name],
                            launches_host_pre_512=host_pre[512][name],
                            launches_mesh=mesh[name]))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"imports", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
