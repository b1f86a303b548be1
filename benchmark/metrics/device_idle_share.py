"""The share of the traced window in which the card ran nothing: one minus
the union of its kernel, copy and fill intervals over the window, in
percent."""


def read(run):
    t = run.trace
    if t is None or not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
