"""The balancing ladder's interface sweeps (``_balance_one_interface``,
K1) and the gauges' update, seconds per instance: the program's sub-span
"ladder/balance", each rung's ended by a synchronize, summed over a
traced run's window."""


def read(run):
    st = run.stage_times
    if not st or not run.completed or "ladder/balance" not in st:
        return None
    return st["ladder/balance"] / run.completed
