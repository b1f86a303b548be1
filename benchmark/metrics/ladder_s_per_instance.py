"""The balancing ladder's seconds per instance (the program's stage
"ladder", ended by a synchronize), summed over a traced run's window."""


def read(run):
    st = run.stage_times
    if not st or not run.completed or "ladder" not in st:
        return None
    return st["ladder"] / run.completed
