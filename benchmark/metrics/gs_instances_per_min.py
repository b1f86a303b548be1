"""Ground states solved per minute: the instances answered in the window
over the whole span from the first start to the last end, host clock."""


def read(run):
    if not run.completed or run.span_s <= 0:
        return None
    return 60.0 * run.completed / run.span_s
