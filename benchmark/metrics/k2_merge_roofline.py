"""K2 ``merge_segments``: the least time of its calls (``roofline``) over
their device time in the trace, in percent."""


def read(run):
    from benchmark.harness.trace import K2_KERNELS
    t = run.trace
    if t is None or not t.kernel_bounds_s["k2"]:
        return None
    device_s = t.device_seconds(K2_KERNELS)
    return 100.0 * sum(t.kernel_bounds_s["k2"]) / device_s \
        if device_s > 0 else None
