"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 benchmark/run.py --workload c2048-gs-device --seed 7 \\
        --seconds 10 --trace 0

Set-up: the imports, the port's kernels loaded (built with nvcc into
``build/tnax_torch/`` on a checkout's first run), the cell's pool of
instances made from ``--seed``, and one unit of the traffic at the cell's
shapes on a small lattice of the same cells, as a warm-up. The window: a
closed loop that starts units (an instance, or a batch) until
``--seconds`` have passed and lets the last one finish. After it the
peak device memory is read, the program's state is freed, and a sample of
the answers is judged against the plain reference. The last line of
standard output is the result as one JSON object; the numbers compared,
each with its limit, are the last lines of standard error and the last
key of the result. ``--trace 1`` reports the per-layer metrics instead of
the end-to-end ones: its window is one unit, whose stage times are
recorded, and the next unit is traced on the card (stopping
the profiler and reading a chimera-2048 instance's 1.5 million events
takes about a minute, and the run has to end within its time limit).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as _cell  # noqa: E402
from benchmark.harness import instances, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tnax")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one the run may not load
    (compared whole: ``tnax_torch`` is not ``tnax``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


class RunData:
    """What the metric readers (``benchmark/metrics``) read."""

    def __init__(self, setup_s, completed, span_s, stage_times=None,
                 trace_data=None):
        self.setup_s = setup_s
        self.completed = completed        # instances answered in the window
        self.span_s = span_s              # first start to last end
        # traced runs: the program's stage seconds summed over the window,
        # and the traced unit after the window
        self.stage_times = stage_times
        self.trace = trace_data


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _units(pool, batch):
    items = list(enumerate(pool))
    return [items[i:i + batch] for i in range(0, len(items) - batch + 1,
                                              batch)]


def _traced_unit(tt, torch, device, call):
    """Run ``call(stage_times)`` with the card traced; returns the
    trace's :class:`trace.TraceData`."""
    spans = trace.StageSpans()
    shapes = trace.KernelShapes(tt, torch)
    dev_trace = trace.DeviceTrace(torch, device)
    dev_trace.start()
    try:
        ks = call(spans)
    finally:
        dev_trace.stop()
        shapes.close()
    stages, prev = [], 0.0
    for name, t in spans.ends:
        stages.append((name, prev, t - dev_trace.t0))
        prev = t - dev_trace.t0
    log(f"profiler: stopped in {dev_trace.stop_s:.3f} s, events read in "
        f"{dev_trace.read_s:.3f} s")
    return trace.TraceData(
        instances=len(ks), events=dev_trace.events,
        window_s=dev_trace.window_s, kernel_bounds_s=shapes.bounds_s(),
        spans=stages)


def run_cell(c, seed, seconds, traced, device, t_start=None, tt=None):
    """Set up, run the window and judge it; returns the result dict."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    if tt is None:
        import tnax_torch as tt
    cfg, traffic = c.config, c.traffic
    driver, check = c.driver(), c.check()
    dtype = getattr(torch, cfg["solver"]["dtype"])
    t_imports = time.perf_counter()
    if device.type == "cuda":
        from tnax_torch.kernels import build
        names = traffic["kernels"]
        with ThreadPoolExecutor(len(names)) as ex:   # one nvcc per source
            list(ex.map(build.load, names))
    t_kernels = time.perf_counter()
    n, batch = cfg["instance"]["cells"], traffic["batch"]
    pool = instances.make_pool(n, seed, traffic["pool"])
    units = _units(pool, batch)
    t_pool = time.perf_counter()
    warm_cfg = dict(cfg, instance=dict(cfg["instance"],
                                       cells=traffic["warmup_cells"]))
    warm = instances.make_pool(traffic["warmup_cells"], seed, batch,
                               stream=1)
    driver.run(tt, warm_cfg, traffic["params"], list(enumerate(warm)),
               device, dtype)
    _sync(torch, device)
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    log(f"setup: {setup_s:.3f} s = imports {t_imports - t_start:.3f} + "
        f"kernels {t_kernels - t_imports:.3f} + pool {t_pool - t_kernels:.3f}"
        f" + warm-up {t_ready - t_pool:.3f}")

    answers, started = [], []
    n_units = 0
    attempted = failed = 0
    stage_times = {} if traced else None
    trace_data = None
    t_first = t_last = None

    def solve(unit, stage_times=None):
        """Run one unit; count what it left unanswered."""
        nonlocal attempted, failed
        ks = [k for k, _ in unit]
        started.extend(ks)
        attempted += len(unit)
        try:
            got = driver.run(tt, cfg, traffic["params"], unit, device, dtype,
                             stage_times)
            _sync(torch, device)
        except Exception:        # a unit that fails is reported, not fatal
            log(traceback.format_exc())
            got = []
        failed += len(set(ks) - {a.k for a in got})
        answers.extend(got)
        return ks

    window_s = 0.0 if traced else seconds
    for unit in units:
        now = time.perf_counter()
        if t_first is not None and now - t_first >= window_s:
            break
        t_first = now if t_first is None else t_first
        ks = solve(unit, stage_times)
        t_last = time.perf_counter()
        n_units += 1
        log(f"unit {n_units}: instances {ks} in {t_last - now:.3f} s")
    else:
        unit = None
        log(f"the pool of {len(pool)} instances ran out before "
            f"{window_s} s")
    span_s = (t_last - t_first) if t_first is not None else 0.0
    completed = len(answers)
    if traced:
        if unit is None:
            raise RuntimeError("no unit left in the pool to trace")
        t0 = time.perf_counter()
        trace_data = _traced_unit(tt, torch, device,
                                  lambda st: solve(unit, st))
        log(f"traced unit: instances {[k for k, _ in unit]} in "
            f"{time.perf_counter() - t0:.3f} s, {len(trace_data.events)} "
            f"device events in {trace_data.window_s:.3f} s")

    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(cfg, pool, started, answers, seed, torch, device,
                            log=log)
    correct = check.passed(numbers) and failed == 0

    run = RunData(setup_s, completed, span_s, stage_times, trace_data)
    metrics = {}
    for m in (c.per_layer if traced else c.end_to_end):
        value = c.reader(m).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": c.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_data is not None:
        dev["busy_s"] = trace_data.busy_s()
        dev["window_s"] = trace_data.window_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in trace.top_ops(trace_data.events)],
            "idle_gaps": [list(x) for x in trace.idle_gaps(
                trace_data.events, trace_data.window_s,
                trace_data.spans)[:10]]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in numbers}
    return result


def card_name(torch):
    """The card's name, with nvidia-smi's name and power limit."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return f"{torch.cuda.get_device_name(0)} ({out})"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)
    c = _cell.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        log(f"{args.workload} needs {c.chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count = {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda:0")
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), device,
                      t_start=T_START)
    found = forbidden_modules()
    if found:
        log(f"modules that the run may not load were loaded: {found}")
        return 3
    log(f"card: {card_name(torch)}")
    for name, chk in result["checks"].items():
        log(f"check {name} = {chk['value']!r} (limit {chk['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
