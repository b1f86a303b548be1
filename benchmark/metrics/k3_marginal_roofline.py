"""K3 ``marginal_epilogue``: the least time of its calls (``roofline``)
over their device time in the trace, in percent."""


def read(run):
    from benchmark.harness.trace import K3_KERNELS
    t = run.trace
    if t is None or not t.kernel_bounds_s["k3"]:
        return None
    device_s = t.device_seconds(K3_KERNELS)
    return 100.0 * sum(t.kernel_bounds_s["k3"]) / device_s \
        if device_s > 0 else None
