"""The balancing ladder's D=8 boundary builds (``engine.build_rho_both``),
seconds per instance: the program's sub-span "ladder/build", each rung's
ended by a synchronize, summed over a traced run's window."""


def read(run):
    st = run.stage_times
    if not st or not run.completed or "ladder/build" not in st:
        return None
    return st["ladder/build"] / run.completed
