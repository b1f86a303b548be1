"""Kernels the card ran per instance in the balancing ladder: the traced
unit's kernel events (copies and fills not counted) that start inside an
interval of the program's stage "ladder" (its key, its sub-spans and
their counters), over the traced unit's instances."""

import bisect


def read(run):
    t = run.trace
    if t is None or not t.instances or not t.events:
        return None
    spans = sorted((s, e) for name, s, e in t.spans
                   if name.split("#")[0].split("/")[0] == "ladder" and e > s)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for ev in t.events:
        if ev.kind != "kernel":
            continue
        i = bisect.bisect_right(starts, ev.start) - 1
        n += i >= 0 and ev.start < spans[i][1]
    return n / t.instances
