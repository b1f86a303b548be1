"""Profiling and phase timing (counterpart of ``tnax/profiling.py``).

The reference's only observability is wall-clock deltas logged per row
(reference `tnac4o/tnac4o.py:407-415`). The port keeps those (the
``"tnax_torch"`` logger reports each row's branch count and seconds)
and traces the card with ``torch.profiler``: :func:`trace` writes a
Chrome trace (Perfetto, chrome://tracing) with the CUDA kernels beside
the host's operators. :func:`phase` times a stretch of work on the wall
clock; the card runs asynchronously, so it waits for the CUDA device in
use before it reads the clock at either end.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("tnax_torch")


def _sync():
    """Wait for the current CUDA device, where CUDA has been used."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the enclosed work with ``torch.profiler`` into ``log_dir``
    (created if missing; no-op when None or empty): host operators, and
    the CUDA kernels where a card is present, written as a Chrome trace
    ``trace_<pid>.json``. Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def phase(name: str, sink: dict | None = None):
    """Wall-clock phase timer: logs the seconds of the enclosed work and
    adds them to ``sink[name]`` when a dict is given. The CUDA device in
    use is synchronized before each reading of the clock."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    logger.info("phase %s: %.3f s", name, dt)
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
