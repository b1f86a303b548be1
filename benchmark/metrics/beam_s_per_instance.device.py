"""The device beam search's seconds per instance (the program's stage
"search"), summed over a traced run's window."""


def read(run):
    st = run.stage_times
    if not st or not run.completed or "search" not in st:
        return None
    return st["search"] / run.completed
