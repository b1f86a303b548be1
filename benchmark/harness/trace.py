"""The traced run: device events of one unit of work, the benchmark's own
spans around the program's stages and the shapes of the kernel calls.

Nothing here runs in an untraced run. The profiler records the card's
activity only (kernels, copies, fills); its events stay in memory and are
read from the profiler's raw results, without building its tables.
"""

from __future__ import annotations

import dataclasses
import re
import time

from . import roofline

# the kernels of the port's CUDA sources, by the file that holds them
K2_KERNELS = frozenset({"tile_hist_kernel", "scan_kernel",
                        "tile_scatter_kernel", "merge_block_kernel",
                        "stage_kernel", "carry_kernel", "round1_kernel",
                        "round2_kernel"})
K3_KERNELS = frozenset({"marginal_kernel"})


def base_name(name: str) -> str:
    """A device event's function name without return type, namespaces,
    template arguments or parameters: ``void ns::f<float>(Args<float>)``
    -> ``f``."""
    head = name.replace("(anonymous namespace)", "anonymous")
    while re.search(r"<[^<>]*>", head):
        head = re.sub(r"<[^<>]*>", "", head)
    head = head.split("(", 1)[0].split()
    return head[-1].split("::")[-1] if head else name


class StageSpans(dict):
    """A ``stage_times`` dict that also notes when each stage ended (the
    program's StageClock writes an entry after a synchronize)."""

    def __init__(self):
        super().__init__()
        self.ends = []

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.ends.append((key, time.perf_counter()))


class Patch:
    """Replace ``obj.name`` by ``wrap(original)`` until closed. A kernel
    wrapper counts its launches in its own ``launches`` attribute, looked
    up by its module-level name, which the patch may be: the count goes
    on in the replacement and is handed back on close."""

    def __init__(self, obj, name, wrap):
        self.obj, self.name = obj, name
        self.original = getattr(obj, name)
        self.replacement = wrap(self.original)
        if hasattr(self.original, "launches"):
            self.replacement.launches = self.original.launches
        setattr(obj, name, self.replacement)

    def close(self):
        if hasattr(self.original, "launches"):
            self.original.launches = max(self.original.launches,
                                         self.replacement.launches)
        setattr(self.obj, self.name, self.original)


class KernelShapes:
    """Records, for each call of K2 and K3 through the names the program
    calls them by, what the least time of that call needs; the bounds are
    worked out after the window (:meth:`bounds_s`), so that the traced
    window holds no extra kernels but copies of K3's small index
    tensors."""

    def __init__(self, tt, torch):
        self.torch = torch
        self.k2, self.k3 = [], []

        def wrap_k2(fn):
            def merge_segments(*args, **kw):
                out = fn(*args, **kw)
                self.k2.append(roofline.k2_bound_s(args[:5], out))
                return out
            return merge_segments

        def wrap_k3(fn):
            def marginal_epilogue(*args, **kw):
                out = fn(*args, **kw)
                T2, lBT, drindex, lidx, uidx, nvalid, prob, valid = args[:8]
                self.k3.append((roofline.Like(T2), roofline.Like(lBT),
                                lidx.clone(), uidx.clone(), nvalid.clone(),
                                roofline.nbytes(prob, valid, *out)))
                return out
            return marginal_epilogue

        self.patches = [
            Patch(tt.parallel, "merge_segments", wrap_k2),
            Patch(tt.engine._marginal, "marginal_epilogue", wrap_k3)]

    def close(self):
        for p in self.patches:
            p.close()

    def bounds_s(self):
        """{"k2": [seconds per call], "k3": [...]}."""
        torch = self.torch
        k3 = []
        for T2, lBT, lidx, uidx, nvalid, rest in self.k3:
            B, M = T2.shape[:2]
            moved = roofline.gathered_bytes(T2, lBT, None, lidx, uidx,
                                            nvalid, torch) + rest
            k3.append(roofline.bound_s(moved, 10 * B * M * lBT.shape[-1],
                                       roofline.dtype_name(T2)))
        self.k3 = []
        return {"k2": list(self.k2), "k3": k3}


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: float      # seconds from the traced window's start
    end: float

    @property
    def kind(self):
        if self.name.startswith("Memcpy"):
            return "memcpy"
        if self.name.startswith("Memset"):
            return "memset"
        return "kernel"


class DeviceTrace:
    """The card's activity between :meth:`start` and :meth:`stop`, on the
    host clock of :meth:`start` (a one-element fill marks the start on
    the device's timeline)."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.events, self.window_s = [], None

    def start(self):
        torch = self.torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        torch.zeros(1, device=self.device).fill_(1.0)

    def stop(self):
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.start_ns(), e.duration_ns(), e.name())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        del self.prof
        raw = [(s, s + d, n) for s, d, n in raw]
        self.read_s = time.perf_counter() - t - self.stop_s
        if not raw:
            return
        raw.sort()
        origin = raw[0][0]       # the marker's start: host time t0
        self.events = [DeviceEvent(n, (s - origin) * 1e-9,
                                   (t - origin) * 1e-9) for s, t, n in raw]


def busy_intervals(events, lo=None, hi=None):
    """The union of the events' intervals, clipped to [lo, hi], as a
    sorted list of disjoint (start, end)."""
    spans = sorted((e.start, e.end) for e in events)
    out = []
    for s, t in spans:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            t = min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def busy_seconds(events, lo=None, hi=None):
    return sum(t - s for s, t in busy_intervals(events, lo, hi))


def idle_gaps(events, window_s, spans):
    """The idle time of the window by what the host was doing: each gap
    between busy intervals is named by the benchmark's span it falls in
    and the kernel that ends it; returns [(name, seconds)] summed by
    name, longest first."""
    busy = busy_intervals(events, 0.0, window_s)
    starts = sorted((e.start, e.name) for e in events)
    gaps, prev = [], 0.0
    for s, t in busy + [(window_s, window_s)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    totals = {}
    j = 0
    for a, b in gaps:
        while j < len(starts) and starts[j][0] < b:
            j += 1
        nxt = short_name(starts[j][1]) if j < len(starts) else "end"
        mid = 0.5 * (a + b)
        stage = next((name for name, s, t in spans if s <= mid < t), "host")
        key = f"{stage}: before {nxt}"
        totals[key] = totals.get(key, 0.0) + (b - a)
    return sorted(totals.items(), key=lambda kv: -kv[1])


def short_name(name):
    """A kernel's function name, or a copy's or fill's kind."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (", 1)[0]
    return base_name(name)


def top_ops(events, n=10):
    """[(kernel name, seconds)] of the device time by function, longest
    first."""
    totals = {}
    for e in events:
        key = short_name(e.name)
        totals[key] = totals.get(key, 0.0) + (e.end - e.start)
    return sorted(totals.items(), key=lambda kv: -kv[1])[:n]


@dataclasses.dataclass
class TraceData:
    """The traced unit, as the per-layer metric readers read it
    (``benchmark/metrics``)."""
    instances: int                 # instances of the traced unit
    events: list                   # DeviceEvent, seconds from its start
    window_s: float
    kernel_bounds_s: dict          # {"k2": [...], "k3": [...]} per call
    spans: list                    # (stage, start, end) on the same clock

    def device_seconds(self, names):
        """Device time of the kernels whose function name is in
        ``names``."""
        return sum(e.end - e.start for e in self.events
                   if e.kind == "kernel" and base_name(e.name) in names)

    def busy_s(self):
        return busy_seconds(self.events, 0.0, self.window_s)
