"""Kernels the card ran per instance in the traced unit (copies and fills
not counted)."""


def read(run):
    t = run.trace
    if t is None or not t.instances or not t.events:
        return None
    return sum(e.kind == "kernel" for e in t.events) / t.instances
